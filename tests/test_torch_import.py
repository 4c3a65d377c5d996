"""The port's readers of reference-format weights against the JAX
package's importers, on the CPU, in fp32 unless stated.

Each reader (`training/checkpoint.py`: the base transformer and the peft
LoRA; `training/import_submodules.py`: the audio, face and router files;
`training/import_encoders.py`: the VAE) equals JAX's importer followed by
`convert.jax_params_to_torch` key for key and bit for bit on JAX's own
synthetic reference dicts (`test_checkpoint._synthetic_reference_sd`,
`test_import_submodules._synth_*_sd`).  Through the readers the tiny DiT
meets the reference mirror (`torch_mirror_dit.py`, interleaved RoPE)
within JAX's own tolerance (2e-4 absolute, 1e-4 relative) and the tiny VAE
its mirror (`torch_mirror_vae.py`; 2e-4 / 5e-4 absolute, 1e-3 relative).
The LoRA fused in fp32 meets JAX's fuse within 1e-6.  `utils/safetensors.py`
equals the `safetensors` package on F32, F16 and BF16 files, sharded,
and refuses a truncated, overlapping or unknown-dtype file and a name in
two shards; a BF16 file reads as JAX's importer reads it.  One deliberate
difference from JAX is pinned: the port permutes the router's q/k packing
with the model's head count (4 at tiny), where JAX's
`import_all_submodules` uses 16.  `chip_smoke.py`'s exporter of drawn
weights, read back, is the identity.
"""

import importlib.util
import os
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_checkpoint import _synthetic_reference_sd
from test_import_submodules import _synth_audio_sd, _synth_face_sd, _synth_router_sd
from torch_mirror_dit import MirrorDiT
from torch_mirror_dit import get_3d_rotary_pos_embed as mirror_rope
from torch_mirror_dit import get_resize_crop_region_for_grid as mirror_crop
from torch_mirror_vae import MirrorVAE
from torch_port_utils import threads_per_worker

from bindyouravatar_tpu.models.dit import DiT as JDiT
from bindyouravatar_tpu.models.vae import CausalVAE as JCausalVAE
from bindyouravatar_tpu.training import checkpoint as jckpt
from bindyouravatar_tpu.training import import_submodules as jsub
from bindyouravatar_tpu.training.import_encoders import import_vae as j_import_vae
from bindyouravatar_tpu_torch.convert import jax_params_to_torch
from bindyouravatar_tpu_torch.models.dit import DiT
from bindyouravatar_tpu_torch.models.vae import CausalVAE
from bindyouravatar_tpu_torch.training import checkpoint as tckpt
from bindyouravatar_tpu_torch.training import import_submodules as tsub
from bindyouravatar_tpu_torch.training.import_encoders import import_vae, vae_state_dict
from bindyouravatar_tpu_torch.utils import safetensors as tst

ROOT = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _threads():
    with threads_per_worker():
        yield


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jdit():
    """JAX's tiny DiT (face and audio on, in 8 / out 4 channels) and its
    init, shared by the cases that need JAX's tree."""
    d = JDiT.tiny(in_channels=8, out_channels=4)
    return d, d.init(jax.random.key(0))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def _tiny(**kw):
    kw.setdefault("in_channels", 8)
    kw.setdefault("out_channels", 4)
    return DiT.tiny(device=CPU, generator=torch.Generator().manual_seed(5), **kw)


# --------------------------------------------------------------- safetensors

def _sample(dtype):
    g = torch.Generator().manual_seed(0)
    return {"a.weight": torch.randn(5, 3, generator=g).to(dtype),
            "a.bias": torch.randn(5, generator=g).to(dtype),
            "b": torch.randn(2, 3, 4, generator=g).to(dtype),
            "scalar": torch.tensor(1.5).to(dtype), "empty": torch.zeros(0, 4, dtype=dtype)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_safetensors_reader_equals_the_package(dtype, tmp_path):
    """Files the `safetensors` package wrote, one and two shards: the port's
    reader gives its tensors, dtype and bits; they are views of the file's
    mapping, not copies."""
    from safetensors.torch import load_file, save_file

    sd = _sample(dtype)
    one, parts = str(tmp_path / "one.safetensors"), []
    save_file(sd, one, metadata={"format": "pt"})
    _equal(tst.load_file(one), load_file(one))
    for k, names in enumerate((["a.weight", "scalar"], ["a.bias", "b", "empty"])):
        parts.append(str(tmp_path / f"m-{k + 1:05d}-of-00002.safetensors"))
        save_file({n: sd[n] for n in names}, parts[-1])
    _equal(tst.load_files(parts), sd)
    got = tst.load_file(one)
    assert got["b"].untyped_storage().data_ptr() == got["a.weight"].untyped_storage().data_ptr()


def test_safetensors_writer_round_trip(tmp_path):
    """The port's `save_file` (every dtype it names, metadata) reads back
    through the `safetensors` package and the port's reader unchanged."""
    from safetensors import safe_open
    from safetensors.torch import load_file

    sd = {**_sample(torch.bfloat16), "f16": torch.ones(3, dtype=torch.float16),
          "i64": torch.arange(7), "u8": torch.arange(5, dtype=torch.uint8),
          "mask": torch.tensor([True, False, True]), "f64": torch.ones(2, 2, dtype=torch.float64)}
    path = str(tmp_path / "w.safetensors")
    n = tst.save_file(sd, path, metadata={"format": "pt"})
    assert n == os.path.getsize(path)
    _equal(load_file(path), sd)
    _equal(tst.load_file(path), sd)
    with safe_open(path, framework="pt") as f:
        assert f.metadata() == {"format": "pt"}
    header, meta, start, size = tst.read_header(path)
    assert meta == {"format": "pt"} and start % 8 == 0 and start + size == n


def _corrupt(path, how):
    import json
    import struct

    raw = open(path, "rb").read()
    (n,) = struct.unpack("<Q", raw[:8])
    header = json.loads(raw[8:8 + n])
    if how == "truncated":
        return raw[:-4]
    if how == "overlap":
        header["b"]["data_offsets"] = [o - 4 for o in header["b"]["data_offsets"]]
    elif how == "unknown dtype":
        header["b"]["dtype"] = "F8_E9M9"
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    return struct.pack("<Q", len(blob)) + blob + raw[8 + n:]


@pytest.mark.parametrize("how,match", [("truncated", "truncated"), ("overlap", "overlap"),
                                       ("unknown dtype", "unknown dtype"),
                                       ("duplicate", "in both")])
def test_safetensors_refuses(how, match, tmp_path):
    sd = {"a": torch.ones(4), "b": torch.zeros(2, 3)}
    path = str(tmp_path / "x.safetensors")
    tst.save_file(sd, path)
    if how == "duplicate":
        other = str(tmp_path / "y.safetensors")
        tst.save_file({"c": torch.ones(1), "b": torch.ones(2, 3)}, other)
        with pytest.raises(ValueError, match=match):
            tst.load_files([path, other])
        return
    bad = _corrupt(path, how)
    with open(path, "wb") as f:
        f.write(bad)
    with pytest.raises(ValueError, match=match):
        tst.load_file(path)


# --------------------------------------------------------------- base transformer

def test_dit_reader_equals_jax_import_and_convert(jdit, tmp_path):
    """JAX's synthetic reference dict, in memory and as two shards: the
    reader's tensors are JAX `import_reference_dit` + convert's, bit for bit,
    for every name of the base transformer; the conditioning modules and
    LoRA slots are not among them."""
    jd, _ = jdit
    sd = _synthetic_reference_sd(jd.cfg)
    want = jax_params_to_torch(_np(jckpt.import_reference_dit(sd, jd)))
    port = _tiny()
    got = tckpt.reference_dit_state_dict(sd, port.cfg)
    base = tckpt.base_names(port)
    assert set(got) == base and base < set(want)
    _equal(got, {k: want[k] for k in base})
    names = sorted(sd)
    files = [str(tmp_path / f"s{k}.safetensors") for k in (0, 1)]
    for k, f in enumerate(files):
        tst.save_file({n: torch.from_numpy(sd[n]) for n in names[k::2]}, f)
    _equal(tckpt.reference_dit_state_dict(files, port.cfg), got)


def test_dit_import_loads_the_base_and_keeps_the_rest(jdit):
    """`import_reference_dit` loads every base tensor into the live DiT and
    leaves the conditioning modules and the LoRA slots as drawn; a missing
    key raises `KeyError` (JAX's too), an unread key is ignored."""
    jd, _ = jdit
    sd = _synthetic_reference_sd(jd.cfg)
    port = _tiny(lora_rank=4)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    tckpt.import_reference_dit({**sd, "unused.weight": np.ones(3, np.float32)}, port)
    after = port.state_dict()
    base = tckpt.base_names(port)
    _equal({k: after[k] for k in base}, tckpt.reference_dit_state_dict(sd, port.cfg))
    rest = set(after) - base
    assert any("_lora_" in k for k in rest) and any(k.startswith("router_") for k in rest)
    assert all(torch.equal(after[k], before[k]) for k in rest)
    short = {k: v for k, v in sd.items() if k != "transformer_blocks.2.attn1.norm_k.weight"}
    for importer in (lambda: tckpt.import_reference_dit(short, _tiny()),
                     lambda: jckpt.import_reference_dit(short, jd)):
        with pytest.raises(KeyError, match="transformer_blocks.2.attn1.norm_k.weight"):
            importer()


def test_dit_channel_growth(jdit):
    """A 4-channel patch embed into the 8-channel DiT: channels 4-7 are
    zero, and the rest is JAX's grown kernel converted."""
    small = JDiT.tiny(is_train_face=False, is_train_audio=False, in_channels=4)
    sd = _synthetic_reference_sd(small.cfg)
    jd, _ = jdit
    want = jax_params_to_torch(_np(jckpt.import_reference_dit(sd, jd)))["patch_embed.proj.weight"]
    port = _tiny()
    tckpt.import_reference_dit(sd, port)
    w = port.patch_embed.proj.weight.detach()
    assert torch.equal(w, want) and w.shape == (96, 8 * 4)
    p = port.cfg.patch_size
    assert w.reshape(96, 8, p * p)[:, 4:].abs().max() == 0
    assert torch.equal(w.reshape(96, 8, p, p)[:, :4], torch.from_numpy(
        sd["patch_embed.proj.weight"]))


def test_dit_forward_meets_the_reference_mirror():
    """The tiny DiT's unconditioned forward with the mirror's weights through
    `import_reference_dit` meets `torch_mirror_dit.MirrorDiT` (interleaved
    RoPE, reference names) at two timesteps, as JAX's within 2e-4 / 1e-4."""
    port = _tiny().eval()
    c = port.cfg
    mirror = MirrorDiT(num_layers=c.num_layers, heads=c.num_attention_heads,
                       head_dim=c.attention_head_dim, in_channels=c.in_channels,
                       out_channels=c.out_channels, time_embed_dim=c.time_embed_dim,
                       text_dim=c.text_embed_dim, patch_size=c.patch_size, eps=c.norm_eps,
                       ff_mult=c.ff_mult).eval()
    g = torch.Generator().manual_seed(11)
    with torch.no_grad():
        for p in mirror.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.05)
    tckpt.import_reference_dit(mirror.state_dict(), port)
    t = c.latent_frames
    crops = mirror_crop(c.latent_grid[1:], 720 // (8 * c.patch_size), 480 // (8 * c.patch_size))
    rope_m = mirror_rope(c.attention_head_dim, crops, c.latent_grid[1:], t)
    rope_p = port.rope(c.sample_height * 8, c.sample_width * 8, t)
    rng = np.random.default_rng(1)
    for step in (321.0, 999.0):
        lat = torch.from_numpy(rng.normal(0, 1, (1, t, c.in_channels, c.sample_height,
                                                 c.sample_width)).astype(np.float32))
        text = torch.from_numpy(rng.normal(0, 1, (1, c.max_text_seq_length,
                                                  c.text_embed_dim)).astype(np.float32))
        ts = torch.tensor([step])
        with torch.no_grad():
            want = mirror(lat, text, ts, rope_m)
            got, _ = port.apply(lat, text, ts, rope_p)
        assert got.shape == want.shape
        torch.testing.assert_close(got, want, atol=2e-4, rtol=1e-4)


def test_bf16_file_equals_jax_import(jdit, tmp_path):
    """The published transformer is bf16.  The port reads the file with
    torch and keeps bf16 until the copy into the DiT; JAX's importer reads
    it through numpy (`safe_open(framework="np")`, which knows bfloat16 only
    once `ml_dtypes` is imported, as `import jax` does) and widens to fp32.
    The two agree bit for bit, and the fp32 DiT holds the bf16 values."""
    from safetensors.torch import save_file

    jd, _ = jdit
    sd = {k: torch.from_numpy(v).to(torch.bfloat16)
          for k, v in _synthetic_reference_sd(jd.cfg).items()}
    path = str(tmp_path / "bf16.safetensors")
    save_file(sd, path)
    got = tckpt.reference_dit_state_dict([path], jd.cfg)
    assert all(t.dtype == torch.bfloat16 for t in got.values())
    want = jax_params_to_torch(_np(jckpt.import_reference_dit([path], jd)))
    _equal({k: t.float() for k, t in got.items()}, {k: want[k] for k in got})
    port = _tiny()
    tckpt.import_reference_dit([path], port)
    live = port.state_dict()
    assert all(torch.equal(live[k], t.float()) for k, t in got.items())


# --------------------------------------------------------------- LoRA

def _peft_lora(cfg, rank, seed, prefix="transformer."):
    rng = np.random.default_rng(seed)
    inner = cfg.num_attention_heads * cfg.attention_head_dim
    sd = {}
    for i in range(cfg.num_layers):
        for proj in ("to_q", "to_k"):
            base = f"{prefix}transformer_blocks.{i}.attn1.{proj}"
            sd[f"{base}.lora_A.weight"] = rng.normal(0, 0.05, (rank, cfg.inner_dim)).astype(
                np.float32)
            sd[f"{base}.lora_B.weight"] = rng.normal(0, 0.05, (inner, rank)).astype(np.float32)
    return sd


@pytest.fixture(scope="module")
def lora_case():
    """JAX's tiny DiT with r4 LoRA slots, its init, and a peft dict."""
    jd = JDiT.tiny(lora_rank=4, in_channels=8, out_channels=4)
    return jd, jd.init(jax.random.key(0)), _peft_lora(jd.cfg, 4, 3)


def test_lora_reader_equals_jax(lora_case, tmp_path):
    """`import_lora_safetensors` (from a file, `transformer.module.` prefixed
    keys) fills the slots with JAX's `import_lora_safetensors` + convert's
    tensors, bit for bit; the base stays as it was."""
    jd, params, sd = lora_case
    want = jax_params_to_torch(_np(jckpt.import_lora_safetensors(sd, jd, params)))
    path = str(tmp_path / "lora.safetensors")
    tst.save_file({k.replace("transformer.", "transformer.module.", 1): torch.from_numpy(v)
                   for k, v in sd.items()}, path)
    port = _tiny(lora_rank=4)
    base = {k: v.clone() for k, v in port.state_dict().items() if "_lora_" not in k}
    tckpt.import_lora_safetensors([path], port)
    live = port.state_dict()
    lora = {k for k in live if "_lora_" in k}
    assert len(lora) == 4 * port.cfg.num_layers
    _equal({k: live[k] for k in lora}, {k: want[k] for k in lora})
    assert all(torch.equal(live[k], v) for k, v in base.items())
    _equal(tckpt.lora_state_dict(sd, port.cfg), {k: want[k] for k in lora})


def test_fuse_lora_files_meets_jax(lora_case):
    """On a rank-0 DiT with JAX's base tensors, `fuse_lora_files` gives JAX's
    fused q/k within 1e-6 (fp32 sums in another order) and leaves every
    other tensor bit for bit."""
    jd, params, sd = lora_case
    attn1 = {k: v for k, v in params["blocks"]["attn1"].items() if "lora" not in k}
    params0 = dict(params, blocks=dict(params["blocks"], attn1=attn1))
    jd0 = JDiT.tiny(lora_rank=0, in_channels=8, out_channels=4)
    want = jax_params_to_torch(_np(jckpt.fuse_lora_files(sd, jd0, params0, lora_alpha=128.0)))
    port = _tiny()
    port.load_state_dict(jax_params_to_torch(_np(params0)))
    tckpt.fuse_lora_files(sd, port, lora_alpha=128.0)
    live = port.state_dict()
    assert set(live) == set(want)
    for k in want:
        if k.endswith(("to_q.weight", "to_k.weight")) and k.startswith("blocks."):
            torch.testing.assert_close(live[k], want[k], atol=1e-6, rtol=1e-6)
            assert not torch.equal(live[k], jax_params_to_torch(_np(params0))[k])
        else:
            assert torch.equal(live[k], want[k]), k


def test_import_then_fuse_equals_fuse_lora_files(lora_case):
    """`import_lora_safetensors` then `fuse_lora` (the slots folded and
    dropped) is what `fuse_lora_files` makes of a rank-0 DiT on the same
    base, bit for bit; the fused rank-0 forward meets the unfused r4 one."""
    _, _, sd = lora_case
    slots = _tiny(lora_rank=4, lora_alpha=128.0)
    tckpt.import_lora_safetensors(sd, slots)
    fused = tckpt.fuse_lora(slots.state_dict(), lora_alpha=128.0)
    assert not any("_lora_" in k for k in fused)
    plain = _tiny()
    plain.load_state_dict({k: v for k, v in slots.state_dict().items() if "_lora_" not in k})
    tckpt.fuse_lora_files(sd, plain, lora_alpha=128.0)
    _equal(plain.state_dict(), fused)
    c = plain.cfg
    rng = np.random.default_rng(4)
    lat = torch.from_numpy(rng.normal(0, 1, (1, c.latent_frames, c.in_channels,
                                             c.sample_height, c.sample_width)).astype(np.float32))
    text = torch.from_numpy(rng.normal(0, 1, (1, c.max_text_seq_length,
                                              c.text_embed_dim)).astype(np.float32))
    rope = plain.rope(c.sample_height * 8, c.sample_width * 8, c.latent_frames)
    with torch.no_grad():
        a, _ = slots.eval().apply(lat, text, torch.tensor([300.0]), rope)
        b, _ = plain.eval().apply(lat, text, torch.tensor([300.0]), rope)
    torch.testing.assert_close(a, b, atol=2e-4, rtol=1e-4)


def test_lora_rank_mismatch_raises(lora_case):
    jd, params, _ = lora_case
    sd = _peft_lora(jd.cfg, 8, 0, prefix="")
    for importer in (lambda: tckpt.import_lora_safetensors(sd, _tiny(lora_rank=4)),
                     lambda: jckpt.import_lora_safetensors(sd, jd, params)):
        with pytest.raises(ValueError, match="rank mismatch"):
            importer()
    with pytest.raises(ValueError, match="lora_rank=0"):
        tckpt.import_lora_safetensors(sd, _tiny())


# --------------------------------------------------------------- sub-modules

SUBMODULES = {
    "audio": (_synth_audio_sd, jsub.import_audio_modules,
              lambda sd, dit: tsub.import_audio_modules(sd)),
    "face": (_synth_face_sd, jsub.import_face_modules,
             lambda sd, dit: tsub.import_face_modules(sd)),
    "router": (_synth_router_sd, lambda sd: jsub.import_router_modules(sd, num_heads=4),
               lambda sd, dit: tsub.import_router_modules(sd, dit.router_cfg.num_heads)),
}


@pytest.mark.parametrize("group", list(SUBMODULES))
def test_submodule_reader_equals_jax(group, jdit, tmp_path):
    """Each sub-module file, in memory and as a bf16 `.pt` file: the
    reader's tensors are JAX's importer + convert's, bit for bit (the bf16
    file's widened), and they are exactly the tiny DiT's group; loading
    through `import_all_submodules` sets them."""
    jd, _ = jdit
    synth, j_import, t_import = SUBMODULES[group]
    sd = synth(jd)
    want = jax_params_to_torch(_np(j_import(sd)))
    port = _tiny()
    got = t_import(sd, port)
    group_names = {k for k, _ in port.named_parameters()
                   if k.startswith(tckpt.SUBMODULE_KEYS[group])}
    assert set(got) == group_names
    _equal(got, want)
    to_bf16 = lambda o: ({k: to_bf16(v) for k, v in o.items()} if isinstance(o, dict) else
                         [to_bf16(v) for v in o] if isinstance(o, list) else
                         torch.from_numpy(o).to(torch.bfloat16))
    path = str(tmp_path / f"{group}_modules.pt")
    torch.save(to_bf16(sd), path)
    from_file = t_import(path, port)
    assert all(t.dtype == torch.bfloat16 for t in from_file.values())
    tsub.import_all_submodules(port, **{group: path})
    live = port.state_dict()
    assert all(torch.equal(live[k], t.float()) for k, t in from_file.items())


def test_router_heads_pin(jdit):
    """The tiny DiT's router has 4 heads.  The port permutes with them: its
    tensors equal JAX's `import_router_modules(sd, num_heads=4)`; JAX's
    `import_all_submodules` (and so JAX's CLI) permutes with 16 and differs."""
    jd, params = jdit
    sd = _synth_router_sd(jd)
    port = _tiny()
    assert port.router_cfg.num_heads == 4
    tsub.import_all_submodules(port, router=sd)
    live = port.state_dict()
    right = jax_params_to_torch(_np(jsub.import_router_modules(sd, num_heads=4)))
    wrong = jax_params_to_torch(_np(jsub.import_all_submodules(params, router=sd)))
    _equal({k: live[k] for k in right}, right)
    for k in ("router_norms.norm_q.weight", "router_layers.0.to_k.weight"):
        assert not torch.equal(live[k], wrong[k])
    assert torch.equal(live["router_trunk.norm.weight"], wrong["router_trunk.norm.weight"])


def test_submodule_files_load_strictly(jdit):
    """A file short of a layer, or with a tensor of another shape, raises
    instead of leaving drawn weights in place."""
    jd, _ = jdit
    audio = _synth_audio_sd(jd)
    short = {k: v for k, v in audio.items() if not k.startswith("layers.3.")}
    with pytest.raises(ValueError, match="missing"):
        tsub.import_all_submodules(_tiny(), audio=short)
    face = _synth_face_sd(jd)
    face["local_facial_extractor"]["latents"] = face["local_facial_extractor"]["latents"][:, :3]
    with pytest.raises(ValueError, match="does not fit"):
        tsub.import_all_submodules(_tiny(), face=face)


# --------------------------------------------------------------- VAE

def test_vae_reader_equals_jax_and_meets_the_mirror(tmp_path):
    """The mirror's diffusers-named state dict (and as a safetensors file):
    the reader equals JAX's `import_vae` + convert bit for bit; the port's
    VAE loaded from it meets the mirror's encoder and decoder as JAX's
    does (2e-4 / 5e-4 absolute, 1e-3 relative)."""
    mirror = MirrorVAE().eval()
    g = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for p in mirror.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.15)
    sd = {k: v.detach().numpy() for k, v in mirror.state_dict().items()}
    jv = JCausalVAE.tiny()
    want = jax_params_to_torch(_np(j_import_vae(sd, jv)))
    vae = CausalVAE.tiny(device=CPU, generator=torch.Generator().manual_seed(1))
    _equal(vae_state_dict(sd, vae.cfg), want)
    path = str(tmp_path / "vae.safetensors")
    tst.save_file(mirror.state_dict(), path)
    import_vae(path, vae)
    _equal(vae.state_dict(), want)
    rng = np.random.default_rng(0)
    video = torch.from_numpy(rng.normal(0, 0.6, (1, 5, 3, 16, 16)).astype(np.float32))
    lat = torch.from_numpy(rng.normal(0, 1.0, (1, 3, 4, 2, 2)).astype(np.float32))
    with torch.no_grad():
        m_t = mirror.encoder(video.permute(0, 2, 1, 3, 4)).permute(0, 2, 1, 3, 4)
        out_t = mirror.decoder(lat.permute(0, 2, 1, 3, 4)).permute(0, 2, 1, 3, 4)
        torch.testing.assert_close(vae.encode_moments(video), m_t, atol=2e-4, rtol=1e-3)
        torch.testing.assert_close(vae.decode(lat * vae.cfg.scaling_factor), out_t, atol=5e-4,
                                   rtol=1e-3)


# --------------------------------------------------------------- the smoke's exporter

def test_exporter_round_trip_is_the_identity(smoke, tmp_path):
    """`chip_smoke.py`'s files of a drawn tiny DiT (with LoRA slots: not
    exported) and VAE, read back into models drawn from another seed: every
    exported tensor comes back bit for bit, the LoRA slots stay as drawn."""
    src = _tiny(lora_rank=4)
    named = {k: v.detach().to(torch.bfloat16) for k, v in src.state_dict().items()}
    paths = smoke.write_reference_files(named, src.cfg, src.router_cfg.num_heads, str(tmp_path),
                                        shards=3)
    assert len(paths["transformer"]) == 3 and paths["bytes"] > 0
    dst = DiT.tiny(device=CPU, generator=torch.Generator().manual_seed(6), lora_rank=4,
                   in_channels=8, out_channels=4)
    lora_before = {k: v.clone() for k, v in dst.state_dict().items() if "_lora_" in k}
    tckpt.import_reference_dit(paths["transformer"], dst)
    tsub.import_all_submodules(dst, audio=paths["audio"], face=paths["face"],
                               router=paths["router"])
    got = dst.state_dict()
    for k, v in named.items():
        if "_lora_" in k:
            assert torch.equal(got[k], lora_before[k])
        else:
            assert torch.equal(got[k], v.float()), k
    vae = CausalVAE.tiny(device=CPU, generator=torch.Generator().manual_seed(1))
    vsd = {k: v.detach() for k, v in vae.state_dict().items()}
    vpath = str(tmp_path / "vae.safetensors")
    tst.save_file(smoke.export_vae(vsd, vae.cfg), vpath)
    other = CausalVAE.tiny(device=CPU, generator=torch.Generator().manual_seed(2))
    import_vae(vpath, other)
    _equal(other.state_dict(), vsd)
    lora = smoke.draw_peft_lora(src.cfg, 4, torch.Generator().manual_seed(0), torch.float32)
    slots = tckpt.lora_state_dict(lora, src.cfg)
    assert {k: v.shape for k, v in slots.items()} == {k: v.shape for k, v in lora_before.items()}

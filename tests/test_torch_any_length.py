"""Clips of any length on the CPU: B5, B5' and B8 past each body's sequence
cap, and a whole decode that holds two whole-clip activations at a time.

On the card, past `packed_attention.MAX_S` (192, 96, 48 at bodies of 64,
128, 256 columns) B5, B5' and B8 run the streamed body of
`csrc/packed_attention.cu` (`chip_smoke.py` phase 2 holds it against the
plain versions there, phase 12 drives it in the 5B model).  Here:
  * the shape rule (`kernel_body`) picks the streamed body past each cap and
    takes every S >= 1 (>= 8 backward) at every dh % 8 == 0 up to 256;
  * the plain B5 and B8, which a CPU tensor takes, against JAX's
    `_slice_kernel` and `_tiny_bwd_pallas(interpret=True)` one past the
    caps of 64 and 256 columns (S = 193 at dh 64, 49 at dh 256);
  * a 2-layer face + audio `DiT.tiny` at T = 201 latent frames (801 pixel
    frames), its `apply` and the gradient of every parameter (`jax.vjp`);
  * the VAE's whole decode with its resnet blocks streamed (the slicing
    forced by lowering `SLICE_ELEMENTS`) against JAX's `CausalVAE.decode`;
  * `pipeline.generate` and the CLI decode a long clip whole: nothing
    chunks unless the caller asks.
fp32 on both sides: 1e-5 relative to an output's magnitude, 1e-4 for the
gradients (more sums in another order).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from bindyouravatar_tpu.config import VAEConfig as JVAEConfig
from bindyouravatar_tpu.models.dit import DiT as JDiT
from bindyouravatar_tpu.models.vae import CausalVAE as JCausalVAE
from bindyouravatar_tpu.ops import packed_attention as jpa
from bindyouravatar_tpu_torch import infer
from bindyouravatar_tpu_torch.config import PipelineConfig
from bindyouravatar_tpu_torch.convert import jax_params_to_torch
from bindyouravatar_tpu_torch.models import vae as tvae
from bindyouravatar_tpu_torch.models.dit import DiT
from bindyouravatar_tpu_torch.models.vae import CausalVAE
from bindyouravatar_tpu_torch.ops import packed_attention as tpa
from bindyouravatar_tpu_torch.pipeline.pipeline import BindYourAvatarPipeline
from torch_port_utils import max_err, realistic, threads_per_worker, to_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(ROOT, "assets")
FRAMES = 801                    # T = (801 - 1) / 4 + 1 = 201 latent frames


@pytest.fixture(autouse=True, scope="module")
def _threads():
    with threads_per_worker():
        yield


def _rel(got, want) -> float:
    return max_err(got, want) / float(np.abs(np.asarray(want)).max())


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ------------------------------------------------------------- shape rule
@pytest.mark.parametrize("dh", [8, 32, 64, 72, 128, 136, 256])
def test_kernel_rule_takes_any_length(dh):
    """Every S >= 1 (B8: >= 8) at head dim dh: "packed" below 8, "tile"
    to 16, "long" to the body's cap, "stream" past it, forward and
    backward; B8 below 8 is the plain version's vjp, as in JAX."""
    cap = tpa.MAX_S[tpa.body_columns(dh)]
    for s in (1, 7, 8, 16, 17, cap, cap + 1, 201, 400, 1000, 4001):
        want = "packed" if s < 8 else "tile" if s <= 16 else "long" if s <= cap else "stream"
        assert tpa.kernel_body(s, 4 * dh, 4) == want, (dh, s)
        if s >= 8:
            assert tpa.kernel_body(s, 4 * dh, 4, backward=True) == want, (dh, s)
        else:
            with pytest.raises(ValueError, match="B8"):
                tpa.kernel_body(s, 4 * dh, 4, backward=True)


# ----------------------------------------------- the plain versions vs JAX
@pytest.mark.parametrize("s,heads,dh", [(193, 2, 64), (49, 2, 256)])
def test_b5_plain_matches_slice_kernel_past_the_cap(s, heads, dh):
    """B5's plain version vs `_slice_kernel` (interpret) one past the caps
    of the 64- and 256-column bodies, 16 rows in blocks of 8."""
    m, c = 16, heads * dh
    rng = np.random.default_rng(s)
    q, k, v = (_normal(rng, m, s, c) for _ in range(3))
    spec = pl.BlockSpec((8, s, c), lambda i: (i, 0, 0))
    want = pl.pallas_call(
        functools.partial(jpa._slice_kernel, heads=heads, sm_scale=dh ** -0.5),
        grid=(m // 8,), in_specs=[spec, spec, spec], out_specs=spec,
        out_shape=jax.ShapeDtypeStruct((m, s, c), jnp.float32),
        interpret=True)(*map(jnp.asarray, (q, k, v)))
    assert _rel(tpa.tiny_seq_attention(*to_torch(q, k, v), heads, dh ** -0.5), want) < 1e-5


@pytest.mark.parametrize("s,heads,dh", [(193, 2, 64), (49, 2, 256)])
def test_b8_plain_matches_slice_bwd_kernel_past_the_cap(s, heads, dh):
    """B8's plain version vs `_slice_bwd_kernel` through
    `_tiny_bwd_pallas(interpret=True)` at the same lengths, 20 rows."""
    m = 20
    rng = np.random.default_rng(s + 1)
    q, k, v, g = (_normal(rng, m, s, heads * dh) for _ in range(4))
    want = jpa._tiny_bwd_pallas(*map(jnp.asarray, (q, k, v, g)), heads, dh ** -0.5,
                                interpret=True)
    got = tpa.tiny_seq_attention_bwd(*to_torch(q, k, v, g), heads, dh ** -0.5)
    for a, b in zip(got, want):
        assert a.shape == (m, s, heads * dh)
        assert _rel(a, b) < 1e-5


# ----------------------------------------------- the model at 201 frames
def test_face_dit_at_201_latent_frames_matches_jax():
    """A 2-layer face + audio `DiT.tiny` on a 2 x 2 latent grid (a token a
    frame, 201 in all) at 801 pixel frames: the router's temporal STAB
    attention over T = 201, the audio windows over 801 + 4 frames.  The
    output and routing against JAX's `DiT.apply`, and for one cotangent the
    gradient of every parameter against `jax.vjp` of it."""
    kw = dict(num_layers=2, sample_height=2, sample_width=2, sample_frames=FRAMES)
    jd, td = JDiT.tiny(**kw), DiT.tiny(device="cpu", **kw).eval()
    params = realistic(jax.eval_shape(jd.init, jax.random.key(0)), seed=201)
    td.load_state_dict(jax_params_to_torch(params), strict=True)
    c, a, lf = jd.cfg, jd.audio_cfg, jd.lfe_cfg
    t = c.latent_frames
    rng = np.random.default_rng(201)
    x = (_normal(rng, 1, t, c.in_channels, c.sample_height, c.sample_width),
         _normal(rng, 1, c.max_text_seq_length, c.text_embed_dim),
         np.array([499.0], np.float32))
    cond = dict(id_cond=_normal(rng, 1, c.num_ids, lf.id_embed_dim),
                id_vit_hidden=_normal(rng, 1, c.num_ids, lf.num_scales, 6, lf.vit_dim),
                audio_embeds=_normal(rng, 1, 2, FRAMES + a.window_size - a.window_stride,
                                     a.blocks, a.audio_dim))
    rope = jd.rope(c.sample_height * 8, c.sample_width * 8, t)
    n_tok = t * (c.sample_height // c.patch_size) * (c.sample_width // c.patch_size)
    cot = _normal(rng, 1, t, c.out_channels, c.sample_height, c.sample_width)
    cot_r = _normal(rng, c.num_ca, 1, n_tok, c.num_ids)

    def apply(p):
        return jd.apply(p, *map(jnp.asarray, x), rope, num_pixel_frames=FRAMES,
                        **{k: jnp.asarray(v) for k, v in cond.items()})

    def forward_and_vjp(p):
        out, vjp = jax.vjp(apply, p)
        return out, vjp((jnp.asarray(cot), jnp.asarray(cot_r)))[0]

    (want, want_r), jgrads = jax.jit(forward_and_vjp)(params)
    got, got_r = td.apply(*to_torch(*x), tuple(to_torch(*rope)), num_pixel_frames=FRAMES,
                          **{k: to_torch(v)[0] for k, v in cond.items()})
    assert t == 201 and got.shape == want.shape and got_r.shape == want_r.shape
    assert _rel(got.detach(), np.asarray(want)) < 1e-5
    assert max_err(got_r.detach(), np.asarray(want_r)) < 1e-5
    ((got * torch.from_numpy(cot)).sum() + (got_r * torch.from_numpy(cot_r)).sum()).backward()
    want_g = jax_params_to_torch(jax.tree_util.tree_map(np.asarray, jgrads))
    named = dict(td.named_parameters())
    assert set(want_g) == set(named)
    for name, p in named.items():
        w = want_g[name]
        if name.endswith("to_k.bias"):
            # softmax ignores a key bias: its true gradient is 0, and both
            # sides hold noise at the scale of their query twin's
            ref = float(want_g[name.replace("to_k.bias", "to_q.bias")].norm())
        else:
            ref = float(w.norm())
        g = torch.zeros_like(p) if p.grad is None else p.grad
        assert float((g - w).norm()) <= 1e-4 * max(ref, 1e-30), name


# ----------------------------------------------------- the whole decode
@pytest.fixture(scope="module")
def vae_run():
    """The tiny VAE on both sides (JAX's tiny shapes, realistic weights),
    latents of 5 frames on a 2 x 3 grid and JAX's decode of them."""
    jv = JCausalVAE(JVAEConfig(block_out_channels=(8, 8, 16, 16), layers_per_block=1,
                               latent_channels=4, norm_num_groups=4, dtype=jnp.float32))
    vp = realistic(jax.eval_shape(jv.init, jax.random.key(1)), seed=2)
    tv = CausalVAE.tiny(device="cpu")
    tv.load_state_dict(jax_params_to_torch(vp), strict=True)
    lat = _normal(np.random.default_rng(9), 1, 5, 4, 2, 3)
    return tv.eval(), lat, np.asarray(jax.jit(jv.decode)(vp, jnp.asarray(lat)))


@pytest.mark.parametrize("limit", [1000, 8000])
def test_whole_decode_streamed_blocks_match_jax(vae_run, monkeypatch, limit):
    """The whole decode with every tensor past `limit` elements sliced: the
    resnet blocks make their convs' inputs a slice at a time (one frame a
    slice at 1,000 elements, two or more at 8,000), write conv2 over
    conv1's output (each slice's causal context kept from the slice before)
    and add the shortcut a slice at a time; against JAX's decode, and the
    blocks did stream."""
    tv, lat, want = vae_run
    streamed = []
    block = tvae.ResnetBlock3D._streamed
    monkeypatch.setattr(tvae, "SLICE_ELEMENTS", limit)
    monkeypatch.setattr(tvae.ResnetBlock3D, "_streamed",
                        lambda self, x, zq: streamed.append(x.shape) or block(self, x, zq))
    got = tv.decode(torch.from_numpy(lat))
    assert got.shape == want.shape == (1, 17, 3, 16, 24)
    assert len(streamed) >= 3
    assert max_err(got, want) / float(np.abs(want).max()) < 1e-5


def _spy_decode(monkeypatch):
    """Record (latent frames, temporal_chunk) of every `CausalVAE.decode`."""
    calls, decode = [], CausalVAE.decode

    def spy(self, latents, temporal_chunk=None):
        calls.append((latents.shape[1], temporal_chunk))
        return decode(self, latents, temporal_chunk)

    monkeypatch.setattr(CausalVAE, "decode", spy)
    return calls


def test_generate_decodes_a_long_clip_whole(monkeypatch):
    """`pipeline.generate` at 801 frames (T = 201) on the tiny DiT and VAE
    (2 x 2 latents): one `decode` of all 201 latent frames, no
    `temporal_chunk`; the clip [1, 801, 3, 16, 16]."""
    calls = _spy_decode(monkeypatch)
    gen = torch.Generator().manual_seed(0)
    td = DiT.tiny(device="cpu", generator=gen, num_layers=2, sample_height=2, sample_width=2,
                  sample_frames=FRAMES).eval()
    pipe = BindYourAvatarPipeline.create(
        td, CausalVAE.tiny(device="cpu", generator=gen).eval(),
        PipelineConfig(height=16, width=16, num_frames=FRAMES, num_inference_steps=1))
    c, a = td.cfg, td.audio_cfg
    rng = np.random.default_rng(3)
    video = pipe.generate(
        torch.from_numpy(_normal(rng, 1, c.max_text_seq_length, c.text_embed_dim)),
        torch.zeros(1, c.max_text_seq_length, c.text_embed_dim),
        torch.from_numpy(rng.uniform(-1, 1, (1, 1, 3, 16, 16)).astype(np.float32)),
        torch.Generator().manual_seed(0),
        audio_embeds=torch.from_numpy(_normal(rng, 1, 2, FRAMES + a.window_size - a.window_stride,
                                              a.blocks, a.audio_dim)))
    assert calls == [(201, None)]
    assert tuple(video.shape) == (1, FRAMES, 3, 16, 16) and bool(video.isfinite().all())


def test_cli_decodes_a_long_clip_whole(tmp_path, monkeypatch):
    """`python -m bindyouravatar_tpu_torch.infer --model_size tiny --device
    cpu --num_frames 801 --height 16 --width 16` from two audio tracks
    (zero-padded to 805 frames): one whole `decode` of 201 latent frames."""
    calls = _spy_decode(monkeypatch)
    argv = ["--model_size", "tiny", "--device", "cpu", "--num_frames", str(FRAMES),
            "--height", "16", "--width", "16", "--num_inference_steps", "1",
            "--output_dir", str(tmp_path / "out"), "--audio_path"]
    argv += [os.path.join(ASSETS, "audio_emb", f"000_{i}.pt") for i in (0, 1)]
    path = infer.main(argv)
    assert os.path.isfile(path) and calls == [(201, None)]

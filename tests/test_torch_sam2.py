"""The port's SAM2 and its mask tool against the JAX package's, on the CPU.

SAM2's stages (`encode_image`, `decode_masks`, `encode_memory`,
`condition_features`, `no_memory_features`) and the whole video predictor
loop (`init_state`, `add_new_points` for two objects on frame 0,
`propagate_in_video` over 5 frames, so the bank reaches its pointer rows
and a second memory) on the same weights: JAX's params drawn at realistic
scale (`torch_port_utils.realistic`), carried across by
`convert.jax_sam2_to_torch`, in fp32 at `SAM2Config.tiny_test()`.  Bound:
a relative L2 of at most `REL_L2` = 1e-4 on every output and every mask
logit.  One case runs at hiera-L's widths and heads (144 wide, 2 heads,
window spec (8, 4, 16, 8), d_model 256, mem_dim 64): its stages cut to one
block each (global block 2), one memory-attention layer, a 128 image.

The reader `load_sam2_predictor` equals JAX's `import_sam2_weights`
followed by `convert.jax_sam2_to_torch`, bit for bit, on the sam2.1-keyed
state dict `tests/test_sam2.py:_export_torch_style` builds; a missing or an
unknown key raises.  The mask tool: `fallback_masks` equals JAX's bit for
bit, `sam2_masks` with injected predictors gives JAX's binary masks, and
the directories `write_masks` writes on each side read into the same
forcing through each side's `masks_to_routing_logits`.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bindyouravatar_tpu.models import sam2 as jsam
from bindyouravatar_tpu.preprocess import sam2_video as jsv
from bindyouravatar_tpu.utils import masks as jmasks
from bindyouravatar_tpu_torch.convert import jax_sam2_to_torch
from bindyouravatar_tpu_torch.models import sam2 as tsam
from bindyouravatar_tpu_torch.preprocess import sam2_video as tsv
from bindyouravatar_tpu_torch.tools import sam2_tools as ttools
from bindyouravatar_tpu_torch.utils import masks as tmasks
from bindyouravatar_tpu_torch.utils import media as tmedia
from torch_port_utils import realistic, threads_per_worker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from tools import sam2_tools as jtools  # noqa: E402  the JAX package's mask tool

REL_L2 = 1e-4
TINY = jsam.SAM2Config.tiny_test()
# hiera-L's widths, heads and window spec; stages cut to one block each
# (global block 2), one memory-attention layer, a 128 image
LARGE_CUT = jsam.SAM2Config(
    hiera=dataclasses.replace(jsam.HieraConfig.large(), stages=(1, 1, 1, 1),
                              global_att_blocks=(2,)),
    image_size=128, memory_attn_layers=1)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    with threads_per_worker():
        yield


def _rel_l2(got, want) -> float:
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(
        got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def port_cfg(cfg: jsam.SAM2Config) -> tsam.SAM2Config:
    fields = dataclasses.asdict(cfg)
    return tsam.SAM2Config(**{**fields, "hiera": tsam.HieraConfig(**fields["hiera"])})


def jax_params(cfg: jsam.SAM2Config, seed: int = 0):
    """JAX `SAM2Model` params (every method traced once, as
    `tests/test_sam2.py` inits them; shapes only) drawn at realistic scale."""
    model, s, k = jsv.SAM2Model(cfg), cfg.image_size, jax.random.key(0)
    m = jsv.SAM2Model

    def init(method, *args):
        return jax.eval_shape(lambda *a: model.init(k, *a, method=method), *args)["params"]

    def apply(method, params, *args):
        return jax.eval_shape(lambda p, *a: model.apply({"params": p}, *a, method=method),
                              params, *args)

    img = jax.ShapeDtypeStruct((1, 3, s, s), jnp.float32)
    params = init(m.encode_image, img)
    enc = apply(m.encode_image, params, img)
    pt, lb = jnp.zeros((1, 1, 2)), jnp.zeros((1, 1), jnp.int32)
    params = {**init(m.decode_masks, enc["feat"], enc["hi0"], enc["hi1"], pt, lb), **params}
    masks = apply(m.decode_masks, params, enc["feat"], enc["hi0"], enc["hi1"], pt, lb)[0]
    low = jax.ShapeDtypeStruct((1,) + masks.shape[2:], jnp.float32)
    params = {**init(m.encode_memory, enc["feat"], low), **params}
    mem = jax.ShapeDtypeStruct((1, (s // 16) ** 2, cfg.mem_dim), jnp.float32)
    params = {**jax.eval_shape(lambda f, x: model.init(k, f, x, x, mem.shape[1],
                                                       method=m.condition_features),
                               enc["feat"], mem)["params"], **params}
    params = {**init(m.no_memory_features, enc["feat"]), **params}
    return realistic(params, seed)


def port_model(cfg: jsam.SAM2Config, params) -> tsv.SAM2Model:
    model = tsv.build_sam2(port_cfg(cfg), "cpu")
    model.load_state_dict(jax_sam2_to_torch(params), strict=True)
    return model


@pytest.fixture(scope="module")
def tiny():
    params = jax_params(TINY)
    return params, port_model(TINY, params)


def _frames(t: int, h: int = 96, w: int = 112, seed: int = 3) -> np.ndarray:
    """A synthetic clip: two bright discs drifting over a noisy background."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    out = rng.integers(0, 60, (t, h, w, 3)).astype(np.uint8)
    for i in range(t):
        for cx, col in ((0.3 * w + 2 * i, (220, 180, 160)), (0.7 * w - 2 * i, (160, 200, 230))):
            disc = (xx - cx) ** 2 + (yy - 0.45 * h) ** 2 < (0.15 * h) ** 2
            out[i][disc] = col
    return out


STAGES = ["encode_image", "decode_masks", "encode_memory", "condition_features",
          "no_memory_features"]


@pytest.mark.parametrize("stage", STAGES)
def test_sam2_stage_matches_jax(tiny, stage):
    params, model = tiny
    jm, s = jsv.SAM2Model(TINY), TINY.image_size
    japply = lambda *a, method: jax.jit(
        lambda *x: jm.apply({"params": params}, *x, method=method),
        static_argnums=(3,) if method is jsv.SAM2Model.condition_features else ())(*a)
    rng = np.random.default_rng(1)
    img = rng.standard_normal((1, 3, s, s)).astype(np.float32)
    jenc = japply(jnp.asarray(img), method=jsv.SAM2Model.encode_image)
    with torch.no_grad():
        tenc = model.encode_image(torch.from_numpy(img))
        t_ = lambda k: torch.from_numpy(np.array(jenc[k]))
        if stage == "encode_image":
            pairs = [(tenc[k], jenc[k]) for k in ("feat", "hi0", "hi1", "pos")]
        elif stage == "decode_masks":
            pts = np.asarray([[[40.0, 50.0], [90.0, 20.0], [0.0, 0.0]]], np.float32)
            lbs = np.asarray([[1, 0, -1]], np.int32)
            want = japply(jenc["feat"], jenc["hi0"], jenc["hi1"], jnp.asarray(pts),
                          jnp.asarray(lbs), method=jsv.SAM2Model.decode_masks)
            got = model.decode_masks(t_("feat"), t_("hi0"), t_("hi1"), torch.from_numpy(pts),
                                     torch.from_numpy(lbs))
            pairs = list(zip(got, want))
        elif stage == "encode_memory":
            logits = 3 * rng.standard_normal((1, s // 4, s // 4)).astype(np.float32)
            want = japply(jenc["feat"], jnp.asarray(logits), method=jsv.SAM2Model.encode_memory)
            got = model.encode_memory(t_("feat"), torch.from_numpy(logits))
            pairs = list(zip(got, want))
        elif stage == "condition_features":
            n = (s // 16) ** 2
            mem = rng.standard_normal((1, 2 * n + 4, TINY.mem_dim)).astype(np.float32)
            pos = rng.standard_normal(mem.shape).astype(np.float32)
            want = japply(jenc["feat"], jnp.asarray(mem), jnp.asarray(pos), 2 * n,
                          method=jsv.SAM2Model.condition_features)
            got = model.condition_features(t_("feat"), torch.from_numpy(mem),
                                           torch.from_numpy(pos), 2 * n)
            pairs = [(got, want)]
        else:
            want = japply(jenc["feat"], method=jsv.SAM2Model.no_memory_features)
            pairs = [(model.no_memory_features(t_("feat")), want)]
    for got, want in pairs:
        assert tuple(got.shape) == tuple(want.shape)
        assert _rel_l2(got, want) <= REL_L2, stage


def _run_loop(predictor, frames, prompts):
    state = predictor.init_state(frames)
    added = [predictor.add_new_points(state, 0, oid, p, np.array([1]))
             for oid, p in enumerate(prompts, start=1)]
    return state, added, list(predictor.propagate_in_video(state))


@pytest.mark.parametrize("case", ["tiny_test", "hiera-L widths, stages cut"])
def test_video_predictor_loop_matches_jax(tiny, case):
    """Two objects prompted on frame 0, then 5 frames propagated: every mask
    logit within REL_L2 of JAX's, frame by frame and object by object; the
    banks reach a second memory and the pointer rows."""
    if case == "tiny_test":
        cfg, (params, model) = TINY, tiny
    else:
        cfg = LARGE_CUT
        params = jax_params(cfg, seed=1)
        model = port_model(cfg, params)
    frames = _frames(5)
    prompts = [np.array([[30.0, 40.0]], np.float32), np.array([[80.0, 44.0]], np.float32)]
    jstate, jadded, jout = _run_loop(jsv.SAM2VideoPredictor(cfg, params), frames, prompts)
    tstate, tadded, tout = _run_loop(tsv.SAM2VideoPredictor(model), frames, prompts)
    for (jids, jm), (tids, tm) in zip(jadded, tadded):
        assert jids == tids and _rel_l2(tm, jm) <= REL_L2
    assert [t for t, _, _ in tout] == list(range(5))
    for (jt, jids, jm), (tt, tids, tm) in zip(jout, tout):
        assert (tt, tids) == (jt, jids) and tm.shape == jm.shape
        for o in range(len(tids)):
            assert _rel_l2(tm[o], jm[o]) <= REL_L2, (tt, o)
    for oid in (1, 2):
        assert len(tstate["objs"][oid].memories) == len(jstate["objs"][oid].memories) == 4
        assert len(tstate["objs"][oid].obj_ptrs) == 5


def _export_sd(params, cfg):
    from test_sam2 import _export_torch_style

    return {k: np.asarray(v) for k, v in _export_torch_style(params, cfg).items()}


def test_reader_equals_jax_importer_and_converter(tiny, tmp_path):
    params, _ = tiny
    sd = _export_sd(params, TINY)
    want = jax_sam2_to_torch(jax.tree.map(np.asarray, jsv.import_sam2_weights(sd, TINY)))
    path = tmp_path / "sam2.1_test.pt"
    extras = {"no_obj_ptr": torch.zeros(1, 32), "obj_ptr_tpos_proj.weight": torch.zeros(16, 32),
              "sam_prompt_encoder.mask_downscaling.0.weight": torch.zeros(4, 1, 2, 2)}
    torch.save({"model": {**{k: torch.from_numpy(v) for k, v in sd.items()}, **extras}}, path)
    for source in (str(path), {k: torch.from_numpy(v) for k, v in sd.items()}):
        got = tsv.load_sam2_predictor(source, port_cfg(TINY), device="cpu").model.state_dict()
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    torch_sd = {k: torch.from_numpy(v) for k, v in sd.items()}
    with pytest.raises(RuntimeError, match="Unexpected"):
        tsv.load_sam2_predictor({**torch_sd, "memory_encoder.extra.weight": torch.zeros(2)},
                                port_cfg(TINY), device="cpu")
    torch_sd.pop("memory_attention.norm.bias")
    with pytest.raises(RuntimeError, match="Missing"):
        tsv.load_sam2_predictor(torch_sd, port_cfg(TINY), device="cpu")


def test_fallback_masks_equal_jax():
    frames = _frames(6, 64, 96, seed=5)
    got, want = ttools.fallback_masks(frames), jtools.fallback_masks(frames)
    assert got.dtype == want.dtype == np.uint8 and np.array_equal(got, want)
    assert got.any()


def test_sam2_masks_and_their_forcing_equal_jax(tiny, tmp_path):
    """`sam2_masks` with injected predictors (JAX's and the port's on the
    same weights, frame-0 prompts from the default points): the same binary
    masks; then each side's `write_masks` directory read by its own
    `masks_to_routing_logits` into the same forcing."""
    params, model = tiny
    frames = _frames(5)
    want = jtools.sam2_masks(frames, predictor=jsv.SAM2VideoPredictor(TINY, params))
    got = ttools.sam2_masks(frames, predictor=tsv.SAM2VideoPredictor(model), device="cpu")
    assert got.shape == want.shape == (2, 5, 96, 112) and got.dtype == np.uint8
    assert np.array_equal(got, want) and 0 < got.mean() < 1
    jtools.write_masks(want, str(tmp_path / "jax"))
    ttools.write_masks(got, str(tmp_path / "port"))
    assert sorted(os.listdir(tmp_path / "port")) == ["1", "2", "valid_frame.json"]
    assert sorted(os.listdir(tmp_path / "port" / "1")) == [
        f"annotated_frame_{i:05d}.png" for i in range(5)]
    grid = (2, 6, 7)
    np.testing.assert_array_equal(tmasks.masks_to_routing_logits(str(tmp_path / "port"), *grid),
                                  jmasks.masks_to_routing_logits(str(tmp_path / "jax"), *grid))


def test_tool_main_writes_the_mask_contract(tmp_path, monkeypatch):
    """`python -m bindyouravatar_tpu_torch.tools.sam2_tools --video ...
    --out_dir ...` without a checkpoint: the fallback masks of the decoded
    clip; with `--sam2_checkpoint` naming a missing file it raises."""
    frames = _frames(6, 64, 96, seed=7)
    video = tmedia.export_to_video(frames, str(tmp_path / "clip.mp4"), fps=8)
    monkeypatch.delenv("BYA_SAM2_CKPT", raising=False)
    ttools.main(["--video", video, "--out_dir", str(tmp_path / "masks"), "--device", "cpu"])
    decoded = tmedia.read_video_frames(video, list(range(6)))
    want = ttools.fallback_masks(decoded)
    assert np.array_equal(tmasks.masks_to_routing_logits(str(tmp_path / "masks"), 2, 4, 6),
                          _routing_of(want, tmp_path / "want"))
    with pytest.raises(FileNotFoundError):
        ttools.main(["--video", video, "--out_dir", str(tmp_path / "m2"), "--device", "cpu",
                     "--sam2_checkpoint", str(tmp_path / "missing.pt")])


def _routing_of(masks, d):
    ttools.write_masks(masks, str(d))
    return tmasks.masks_to_routing_logits(str(d), 2, 4, 6)


def test_read_video_frames_equals_jax(tmp_path):
    from bindyouravatar_tpu.training.data import read_video_frames as jread

    video = tmedia.export_to_video(_frames(4, 48, 64), str(tmp_path / "c.mp4"), fps=8)
    idx = [3, 0, 2]
    assert np.array_equal(tmedia.read_video_frames(video, idx), jread(video, idx))
    with pytest.raises(IOError, match="missing frames"):
        tmedia.read_video_frames(video, [0, 9])

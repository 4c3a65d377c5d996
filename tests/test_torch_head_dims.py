"""The flat attention kernels' head dims 32 and 128 (B1, B7), beside 64,
against the JAX package on the CPU, fp32.

* The 3D RoPE tables at dh 32 and 128 against JAX's, before any kernel: a
  wrong split of the head dim into its temporal, height and width parts
  would pass every kernel-against-plain check.
* B1's plain version against `_fwd_flat_t_impl(interpret=True)` and B7's
  plain forward (output, LSE) and backward against `_fwd_flat_impl` /
  `jax.value_and_grad` of the `_flash_flat` custom vjp in interpret mode,
  at 4 heads of 32 and 2 heads of 128: QK-LN (B1), RoPE, 320 rows (not a
  multiple of the 128-row block) with kv rows >= 248 masked.  Tolerance:
  fp32 on both sides, 1e-5 of the output's largest magnitude (the kernels
  reassociate the softmax), 1e-4 absolute on the LSE.
* A 2-layer DiT (face + audio, LoRA r4) with 3 heads of 128 and with 12
  heads of 32 (both pair into 128 lanes: the flat kernels' path) against
  JAX's `DiT.apply` on the inference path (fused QK-LN: B1's plain
  version) within 1e-5 of the output's magnitude, and one Stage-3
  `train_step` (B7's plain versions) against JAX's on JAX's draws: loss
  and metrics within 1e-4 relative, the step's gradients within relative
  L2 1e-5 (each tensor 1e-4).
* The dispatch: 32-wide heads that do not pair (6 heads) take the bshd
  kernels; a flat head dim the flat kernels refuse raises by name (JAX's
  packing rule, D % 8 != 0, D > 256); the STAB attention at dh 192 and
  512 raises instead of calling sdpa (the dh 128 case against JAX is in
  `tests/test_torch_face_models.py`, dh 256 in
  `tests/test_torch_head_dims_general.py`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bindyouravatar_tpu.config import SchedulerConfig as JSchedulerConfig
from bindyouravatar_tpu.config import TrainConfig as JTrainConfig
from bindyouravatar_tpu.models.dit import DiT as JDiT
from bindyouravatar_tpu.ops import flash_attention as jfa
from bindyouravatar_tpu.ops.rope import get_3d_rotary_pos_embed as jrope
from bindyouravatar_tpu.ops.scheduler import Schedule as JSchedule
from bindyouravatar_tpu.training import trainer as jtrainer
from bindyouravatar_tpu_torch.config import SchedulerConfig, TrainConfig
from bindyouravatar_tpu_torch.convert import jax_params_to_torch
from bindyouravatar_tpu_torch.models import router as trouter
from bindyouravatar_tpu_torch.models.dit import DiT
from bindyouravatar_tpu_torch.models.layers import JointSelfAttention
from bindyouravatar_tpu_torch.ops import flash_attention as tfa
from bindyouravatar_tpu_torch.ops.rope import get_3d_rotary_pos_embed
from bindyouravatar_tpu_torch.ops.scheduler import Schedule
from bindyouravatar_tpu_torch.training.trainer import Trainer
from test_torch_train_slice import _batch, jax_draws
from torch_port_utils import max_err, realistic, threads_per_worker, to_torch

HEADS = {32: 4, 128: 2}            # kernel cases: head dim -> heads
DIT_HEADS = {32: 12, 128: 3}       # DiT cases: inner 384 (the LFE wants a multiple of 3)
LR = 1e-3
CFG = dict(learning_rate=LR, lr_warmup_steps=0, max_train_steps=10)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    with threads_per_worker():
        yield


def _rel(got, want) -> float:
    return max_err(got, want) / float(np.abs(np.asarray(want)).max())


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _qk_norm(rng, d):
    return [(1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32),
            (0.1 * rng.standard_normal(d)).astype(np.float32),
            (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32),
            (0.1 * rng.standard_normal(d)).astype(np.float32)]


@pytest.mark.parametrize("d", [32, 128])
def test_rope_tables_match_jax(d):
    """The 3D RoPE tables (temporal, height and width parts of the head
    dim) and the DiT's `rope` at dh 32 and 128 against JAX's."""
    for grid, frames in (((8, 10), 3), ((30, 45), 13)):
        got = get_3d_rotary_pos_embed(d, ((0, 0), grid), grid, frames)
        want = jrope(d, ((0, 0), grid), grid, frames)
        for g, w in zip(got, want):
            assert g.shape == (frames * grid[0] * grid[1], d)
            assert max_err(g, np.asarray(w)) < 1e-6
    jd = JDiT.tiny(num_attention_heads=DIT_HEADS[d], attention_head_dim=d)
    td = DiT.tiny(device="meta", num_attention_heads=DIT_HEADS[d], attention_head_dim=d)
    for g, w in zip(td.rope(128, 192, 3, device="cpu"), jd.rope(128, 192, 3)):
        assert max_err(g, np.asarray(w)) < 1e-6


def _case(d, seed):
    """q/k/v [1, 320, H*d] with RoPE on rows 8..247 (3 x 8 x 10 video rows
    after 8 text rows) and kv rows >= 248 masked."""
    h, text_len, s = HEADS[d], 8, 320
    cos, sin = (np.asarray(t) for t in jrope(d, ((0, 0), (8, 10)), (8, 10), 3))
    rng = np.random.default_rng(seed)
    q, k, v = (_normal(rng, 1, s, h * d) for _ in range(3))
    return dict(h=h, s=s, text_len=text_len, kv_len=text_len + cos.shape[0], cos=cos, sin=sin,
                q=q, k=k, v=v, norm=_qk_norm(rng, d))


def _padded_tables(c, d):
    """JAX's flat kernels take whole-sequence tables: identity outside the
    RoPE rows."""
    tail = c["s"] - c["text_len"] - c["cos"].shape[0]
    pad = lambda t, fill: jnp.asarray(np.concatenate([np.full((c["text_len"], d), fill,
                                                              np.float32), t,
                                                      np.full((tail, d), fill, np.float32)]))
    return pad(c["cos"], 1.0), pad(c["sin"], 0.0)


@pytest.mark.parametrize("d", [32, 128])
def test_b1_plain_matches_flat_t_kernel_interpret(d):
    """B1's plain version vs `_fwd_flat_t_impl(interpret=True)`, QK-LN and
    RoPE fused, on the rows < kv_len."""
    c = _case(d, 41)
    h, kv = c["h"], c["kv_len"]
    want = jfa._fwd_flat_t_impl(
        jnp.asarray(c["q"]), jnp.asarray(c["k"]), jnp.swapaxes(jnp.asarray(c["v"]), 1, 2), h,
        _padded_tables(c, d), d ** -0.5, kv, 128, 128, True,
        qk_norm=tuple(map(jnp.asarray, c["norm"])))
    got = tfa.flash_attention(*to_torch(c["q"], c["k"], c["v"]), h, kv_len=kv,
                              rope=tuple(to_torch(c["cos"], c["sin"])),
                              rope_start=c["text_len"], qk_norm=tuple(to_torch(*c["norm"])))
    assert _rel(got[:, :kv], np.asarray(want)[:, :kv]) < 1e-5


@pytest.mark.parametrize("d", [32, 128])
def test_b7_plain_forward_and_backward_match_flat_kernels_interpret(d):
    """B7's plain forward (output, LSE) and backward (dq, dk, dv from dO,
    LSE and delta) vs `_fwd_flat_impl(save_residuals=True)` and
    `jax.value_and_grad` of `flash_attention(layout="flat",
    interpret=True)` (`_fwd_flat_kernel`, `_bwd_flat_kernel`)."""
    c = _case(d, 42)
    h, s, kv, text_len = c["h"], c["s"], c["kv_len"], c["text_len"]
    cos, sin = jnp.asarray(c["cos"]), jnp.asarray(c["sin"])

    def flat_loss(q, k, v):
        o = jfa.flash_attention(q, k, v, layout="flat", heads=h, kv_len=kv, rope=(cos, sin),
                                rope_start=text_len, block_q=128, block_k=128, interpret=True)
        return (o[:, :kv] ** 2).sum(), o

    qkv = [jnp.asarray(c[n]) for n in "qkv"]
    (_, o_want), grads = jax.value_and_grad(flat_loss, argnums=(0, 1, 2), has_aux=True)(*qkv)
    _, lse_want = jfa._fwd_flat_impl(*qkv, h, _padded_tables(c, d), d ** -0.5, kv, 128, 128,
                                     True, save_residuals=True)
    lse_want = np.asarray(lse_want).reshape(1, h, s)
    q, k, v = to_torch(c["q"], c["k"], c["v"])
    rope = tuple(to_torch(c["cos"], c["sin"]))
    o, lse = tfa.flash_attention_flat_fwd(q, k, v, h, kv_len=kv, rope=rope, rope_start=text_len)
    assert _rel(o, o_want) < 1e-5
    assert max_err(lse, lse_want) < 1e-4
    do = 2 * o * (torch.arange(s) < kv)[None, :, None]
    got = tfa.flash_attention_flat_bwd(q, k, v, do, lse, tfa.attention_delta(o, do, h), h,
                                       kv_len=kv, rope=rope, rope_start=text_len)
    for g, w in zip(got, grads):
        assert _rel(g, w) < 1e-5


def test_flat_head_dims_and_the_refusal():
    """The flat kernels take the heads JAX's flat kernels take, those that
    pack into 128 lanes: 8, 16, 32, 64, 128 and 256.  2 heads of 48 or 96
    (JAX asserts: `ops/flash_attention.py:490`), 32 heads of 4 (JAX packs
    them; the port's kernels need D % 8 == 0: ROADMAP.md queue B item 3)
    and 1 head of 512 (past the port's widest body: item 4) raise, naming
    the rule, before a kernel is asked (the check a CUDA tensor meets)."""
    for d in (8, 16, 32, 64, 128, 256):
        tfa.check_flat_head_dim(max(1, 128 // d) * 2 * d, max(1, 128 // d) * 2)
    for hd, h in ((96, 2), (192, 2)):
        with pytest.raises(ValueError, match=f"head dim {hd}/{h}.*do not pack.*py:490"):
            tfa.check_flat_head_dim(hd, h)
    with pytest.raises(ValueError, match="head dim 4:.*queue B item 3"):
        tfa.check_flat_head_dim(128, 32)
    with pytest.raises(ValueError, match="head dim 512:.*queue B item 4"):
        tfa.check_flat_head_dim(512, 1)
    meta = torch.empty((1, 1024, 96), device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim 96/2"):
        tfa.flash_attention_flat_fwd(meta, meta, meta, 2)


@pytest.mark.parametrize("heads,path", [(4, "flat"), (6, "bshd")])
def test_32_wide_heads_take_the_flat_kernels_when_they_pair(heads, path, monkeypatch):
    """The training path's rule `heads % (128 // 32) == 0`: 4 heads of 32
    reach the flat B7 forward, 6 heads the bshd B11 forward (which takes
    32 since the kernels take every D % 8 == 0 up to 256); on meta tensors
    each wrapper's own check then raises (no QK-LN here: B10 would raise
    first on meta tensors)."""
    asked = []

    def record(name, real):
        def fn(*args, **kw):
            asked.append(name)
            return real(*args, **kw)
        return fn

    monkeypatch.setattr(tfa, "flash_attention_flat_fwd",
                        record("flat", tfa.flash_attention_flat_fwd))
    monkeypatch.setattr(tfa, "flash_attention_fwd", record("bshd", tfa.flash_attention_fwd))
    attn = JointSelfAttention(heads * 32, heads, 32, qk_norm=False,
                              compute_dtype=torch.bfloat16).to("meta")
    x = torch.empty((1, 1100, heads * 32), device="meta", requires_grad=True)
    enc = torch.empty((1, 24, heads * 32), device="meta")
    with pytest.raises(ValueError, match="tensors on meta"):
        attn(x, enc, None)
    assert asked == [path]


def test_stab_attention_refuses_other_flash_head_dims():
    """The STAB attention at S >= 1,024 and a multiple of 64 (where JAX
    takes its flash kernel) raises rather than call sdpa where the flat
    kernels refuse: dh 192 (does not pack into 128 lanes, which JAX's flat
    kernels assert) and dh 512 (past the port's widest body, ROADMAP.md
    queue B item 4); dh 256 reaches them (the case against JAX is in
    `tests/test_torch_head_dims_general.py`)."""
    attn = trouter.SelfAttention(192, heads=1, compute_dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="head dim 192.*flash_attention.py:490"):
        attn(torch.zeros((1, 1024, 192)))
    attn = trouter.SelfAttention(512, heads=1, compute_dtype=torch.float32).to("meta")
    with pytest.raises(NotImplementedError, match="head dim 512.*queue B item 4"):
        attn(torch.zeros((1, 1024, 512), device="meta"))
    attn = trouter.SelfAttention(256, heads=1, compute_dtype=torch.float32).to("meta")
    with pytest.raises(ValueError, match="tensors on meta"):
        attn(torch.zeros((1, 1024, 256), device="meta"))


# ------------------------------------------------------------ 2-layer DiT
def _dits(d, fuse: bool):
    kw = dict(num_attention_heads=DIT_HEADS[d], attention_head_dim=d, num_layers=2,
              lora_rank=4, fuse_qk_norm=fuse)
    jd = JDiT.tiny(**kw)
    params = realistic(jax.eval_shape(jd.init, jax.random.key(0)), seed=6)
    td = DiT.tiny(device="cpu", **kw)
    td.load_state_dict(jax_params_to_torch(params), strict=True)
    return jd, params, td


@pytest.mark.parametrize("d", [32, 128])
def test_dit_inference_forward_matches_jax(d):
    """The inference path (fused QK-LN: B1's plain version) of a 2-layer
    DiT with face + audio against JAX's `DiT.apply`."""
    jd, params, td = _dits(d, fuse=True)
    c, a, lf = jd.cfg, jd.audio_cfg, jd.lfe_cfg
    rng = np.random.default_rng(7)
    f = lambda *shape: _normal(rng, *shape)
    n_af = c.sample_frames + a.window_size - a.window_stride
    x = dict(lat=f(1, c.latent_frames, c.in_channels, c.sample_height, c.sample_width),
             txt=f(1, c.max_text_seq_length, c.text_embed_dim), ts=np.array([321.0], np.float32))
    cond = dict(id_cond=f(1, c.num_ids, lf.id_embed_dim),
                id_vit_hidden=f(1, c.num_ids, lf.num_scales, 6, lf.vit_dim),
                audio_embeds=f(1, 2, n_af, a.blocks, a.audio_dim))
    rope = jd.rope(c.sample_height * 8, c.sample_width * 8, c.latent_frames)
    want, want_r = jax.jit(lambda p: jd.apply(p, *map(jnp.asarray, (x["lat"], x["txt"], x["ts"])),
                                              rope, **{k: jnp.asarray(v)
                                                       for k, v in cond.items()}))(params)
    with torch.no_grad():
        got, got_r = td.apply(*to_torch(x["lat"], x["txt"], x["ts"]),
                              td.rope(c.sample_height * 8, c.sample_width * 8, c.latent_frames),
                              **{k: to_torch(v)[0] for k, v in cond.items()})
    assert _rel(got, np.asarray(want)) < 1e-5
    assert max_err(got_r, np.asarray(want_r)) < 1e-5


@pytest.mark.parametrize("d", [32, 128])
def test_dit_train_step_matches_jax(d):
    """One Stage-3 `train_step` of 2 micro-batches (B7's plain versions)
    against JAX's on the same params, batch and draws: loss, every metric
    and grad_norm; and the step's mean gradients against JAX's
    `_grads_and_metrics`, all together within relative L2 1e-5, each
    tensor within 1e-4 (a key bias, whose true gradient is 0, against its
    query twin's norm), as `tests/test_torch_dit_2b.py` holds its
    gradients.  (The updated tensors are not compared: Adam's first move
    g / (|g| + eps) turns the rounding noise of a gradient that is nearly
    0 into a visible step.)"""
    jd, params, td = _dits(d, fuse=False)
    jcfg = JTrainConfig(**CFG)
    base = jtrainer.Trainer(dit=jd, schedule=JSchedule.create(JSchedulerConfig()), cfg=jcfg)
    grads_fn = jax.jit(base._grads_and_metrics)

    class Jitted(jtrainer.Trainer):
        def _grads_and_metrics(self, p, frozen, batch, rng):
            return grads_fn(p, frozen, batch, rng)

    jtr = Jitted(dit=jd, schedule=base.schedule, cfg=jcfg)
    batch = _batch(jd)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    state, frozen = jtr.init_state(jax.tree.map(jnp.asarray, params))
    jgrads, _ = grads_fn(state.params, frozen, jbatch, jax.random.key(5))
    _, jm = jtr.train_step(state, frozen, jbatch, jax.random.key(5))
    tr = Trainer(td, Schedule.create(SchedulerConfig()), TrainConfig(**CFG))
    draws = jax_draws(jcfg, batch, jax.random.key(5), 2)
    grads, _ = tr.grads_and_metrics(tbatch, draws)
    _, tm = tr.train_step(tr.init_state(), tbatch, draws=draws)
    assert set(tm) == set(jm)
    for k in jm:
        assert abs(float(tm[k]) - float(jm[k])) <= 1e-4 * max(abs(float(jm[k])), 1e-6), k
    want = jax_params_to_torch(jax.tree.map(np.asarray, jgrads))
    assert set(want) == set(grads)
    key_bias = ("to_k.bias", "norm_k.bias")
    for k, g in grads.items():
        ref = want[k.replace("_k.bias", "_q.bias")] if k.endswith(key_bias) else want[k]
        rel = float((g - want[k]).norm()) / max(float(ref.norm()), 1e-30)
        assert rel <= 1e-4, (k, rel)
    rest = [k for k in grads if not k.endswith(key_bias)]
    diff = sum(float((grads[k] - want[k]).double().square().sum()) for k in rest)
    norm = sum(float(want[k].double().square().sum()) for k in rest)
    assert (diff / norm) ** 0.5 <= 1e-5

"""The port's ops against the JAX package, on the CPU, in fp32.

Each kernel-holding op's plain version (the path a CPU tensor takes) is held
against the Pallas kernel it replaces, run as the JAX package's own tests run
it (interpret mode); the kernel-free ops against their JAX twins.  Inputs are
made with numpy and handed to both sides.  Tolerances: fp32 on both sides, so
differences are summation order and the kernels' exp2/online-softmax
reassociation: 2e-5 absolute on O(1) outputs unless stated.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from bindyouravatar_tpu.config import SchedulerConfig as JSchedulerConfig
from bindyouravatar_tpu.ops import flash_attention as jfa
from bindyouravatar_tpu.ops import layernorm as jln
from bindyouravatar_tpu.ops import short_kv_attention as jskv
from bindyouravatar_tpu.ops.patch import patchify as jpatchify, unpatchify as junpatchify
from bindyouravatar_tpu.ops.rope import (get_3d_rotary_pos_embed as jrope,
                                         get_resize_crop_region_for_grid as jcrop,
                                         timestep_embedding as jtemb)
from bindyouravatar_tpu.ops.scheduler import Schedule as JSchedule
from bindyouravatar_tpu_torch.config import SchedulerConfig
from bindyouravatar_tpu_torch.ops import flash_attention as tfa
from bindyouravatar_tpu_torch.ops import layernorm as tln
from bindyouravatar_tpu_torch.ops import short_kv_attention as tskv
from bindyouravatar_tpu_torch.ops.patch import patchify, unpatchify
from bindyouravatar_tpu_torch.ops.rope import (apply_rotary_emb, get_3d_rotary_pos_embed,
                                               get_resize_crop_region_for_grid,
                                               timestep_embedding)
from bindyouravatar_tpu_torch.ops.scheduler import Schedule
from torch_port_utils import max_err, to_torch


def _qk_norm(rng, d):
    """LN affines at realistic scale: gains ~ N(1, 0.1), biases ~ N(0, 0.1)."""
    return [(1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32),
            (0.1 * rng.standard_normal(d)).astype(np.float32),
            (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32),
            (0.1 * rng.standard_normal(d)).astype(np.float32)]


# --------------------------------------------------------------------- B1
@pytest.mark.parametrize("s,kv_len,text_len,fused", [
    (320, 248, 8, True),     # S not a multiple of the 128 block, masked kv tail
    (320, 320, 0, False),    # bare path: no LN, no RoPE, full kv
])
def test_b1_plain_matches_flat_t_kernel_interpret(s, kv_len, text_len, fused):
    """Plain B1 vs `_fwd_flat_t_impl(interpret=True)` (the TPU kernel, with
    its static-max softmax behind the fused LN) on the rows < kv_len."""
    b, h, d = 1, 4, 64
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal((b, s, h * d)).astype(np.float32) for _ in range(3))
    cos, sin = jrope(d, ((0, 0), (8, 10)), (8, 10), 3)           # 240 video rows
    cos, sin = np.asarray(cos), np.asarray(sin)
    norm = _qk_norm(rng, d) if fused else None
    rope_t = None
    if fused:
        tail = s - text_len - cos.shape[0]
        rope_t = tuple(jnp.asarray(np.concatenate([np.full((text_len, d), fill, np.float32), tab,
                                                   np.full((tail, d), fill, np.float32)]))
                       for tab, fill in ((cos, 1.0), (sin, 0.0)))
    want = jfa._fwd_flat_t_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.swapaxes(jnp.asarray(v), 1, 2), h, rope_t,
        d ** -0.5, kv_len, 128, 128, True,
        qk_norm=None if norm is None else tuple(map(jnp.asarray, norm)))
    got = tfa.flash_attention_plain(
        *to_torch(q, k, v), h, kv_len=kv_len,
        rope=tuple(to_torch(cos, sin)) if fused else None, rope_start=text_len,
        qk_norm=None if norm is None else tuple(to_torch(*norm)))
    assert max_err(got[:, :kv_len], np.asarray(want)[:, :kv_len]) < 2e-5


def test_b1_wrapper_matches_flash_attention_flat_interpret():
    """The dispatching wrapper on CPU tensors (plain path, no launch) vs the
    JAX entry `flash_attention(layout="flat", v_transposed=True)`."""
    b, h, d, text_len, s = 1, 4, 64, 8, 300      # 300 = 8 text + 240 video + 52 tail
    kv_len = 290
    rng = np.random.default_rng(12)
    q, k, v = (rng.standard_normal((b, s, h * d)).astype(np.float32) for _ in range(3))
    cos, sin = jrope(d, ((0, 0), (8, 10)), (8, 10), 3)
    norm = _qk_norm(rng, d)
    want = jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.swapaxes(jnp.asarray(v), 1, 2), kv_len=kv_len,
        rope=(cos, sin), rope_start=text_len, layout="flat", heads=h, v_transposed=True,
        qk_norm=tuple(map(jnp.asarray, norm)), block_q=128, block_k=128, interpret=True)
    before = tfa.flash_attention.launches
    got = tfa.flash_attention(*to_torch(q, k, v), h, kv_len=kv_len,
                              rope=tuple(to_torch(cos, sin)), rope_start=text_len,
                              qk_norm=tuple(to_torch(*norm)))
    assert tfa.flash_attention.launches == before      # CPU: plain version
    assert max_err(got[:, :kv_len], np.asarray(want)[:, :kv_len]) < 2e-5


def test_kernel_wrappers_raise_off_cpu():
    """A tensor that is not on the CPU never takes a plain version: off the
    CPU the wrappers launch their kernel or raise (here: meta tensors)."""
    meta = lambda *shape: torch.empty(shape, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        tfa.flash_attention(meta(1, 64, 128), meta(1, 64, 128), meta(1, 64, 128), 2)
    with pytest.raises(ValueError):
        tskv.short_kv_attention_combined_flat(meta(2, 64, 128), meta(2, 2, 2, 32, 64),
                                              meta(2, 2, 2, 32, 64), meta(2, 64, 2), 0.125)
    with pytest.raises(ValueError):
        tln.fused_layernorm(meta(4, 768), meta(768), meta(768))


# --------------------------------------------------------------------- B3
@pytest.mark.parametrize("uniform,d", [pytest.param(True, 64, id="True"),
                                       pytest.param(False, 64, id="False"),
                                       (False, 16), (False, 32), (False, 128), (False, 256)])
def test_b3_plain_matches_kernel_flat_interpret(uniform, d):
    """Plain B3 vs the `_kernel_flat` Pallas call (interpret) and the JAX
    spec, with the audio-only routing weights (0.5 for both identities) and
    with non-uniform weights; at the 5B's D = 64 and at the other head dims
    that `_call_kernel_flat` packs (hpb = max(1, 128 // D) heads a block:
    16, 32, 128, 256), which the audio layers of DiTs with those heads
    reach."""
    hpb = max(1, 128 // d)
    g, h, sq, n_id, kk = 3, 2 * hpb, 40, 2, 8
    rng = np.random.default_rng(13)
    q = rng.standard_normal((g, sq, h * d)).astype(np.float32)
    k, v = (rng.standard_normal((g, n_id, h, kk, d)).astype(np.float32) for _ in range(2))
    w = (np.full((g, sq, n_id), 0.5, np.float32) if uniform
         else rng.uniform(0, 1, (g, sq, n_id)).astype(np.float32))
    sm, rows = d ** -0.5, 8
    got_kernel = pl.pallas_call(
        functools.partial(jskv._kernel_flat, n_id=n_id, hpb=hpb, dh=d, sm_scale=sm),
        grid=(g, h // hpb, sq // rows),
        in_specs=[
            pl.BlockSpec((1, rows, hpb * d), lambda gi, hp, qi: (gi, qi, hp)),
            pl.BlockSpec((1, n_id, hpb, kk, d), lambda gi, hp, qi: (gi, 0, hp, 0, 0)),
            pl.BlockSpec((1, n_id, hpb, kk, d), lambda gi, hp, qi: (gi, 0, hp, 0, 0)),
            pl.BlockSpec((1, rows, n_id), lambda gi, hp, qi: (gi, qi, 0)),
        ],
        out_specs=pl.BlockSpec((1, rows, hpb * d), lambda gi, hp, qi: (gi, qi, hp)),
        out_shape=jax.ShapeDtypeStruct((g, sq, h * d), jnp.float32),
        interpret=True)(*map(jnp.asarray, (q, k, v, w)))
    want_spec = jskv._spec_combined_flat(*map(jnp.asarray, (q, k, v, w)), sm)
    got = tskv.short_kv_attention_combined_flat(*to_torch(q, k, v, w), sm)
    assert max_err(got, got_kernel) < 2e-5
    assert max_err(got, want_spec) < 2e-5


# --------------------------------------------------------------------- B6
@pytest.mark.parametrize("rows,d", [(8, 128), (24, 768)])
def test_b6_plain_matches_ln_kernel_interpret(rows, d):
    """Plain B6 vs the `_ln_kernel` Pallas call (interpret); tol 1e-5 on
    outputs of magnitude ~3 (fp32 on both sides)."""
    rng = np.random.default_rng(14)
    x = (rng.standard_normal((rows, d)) * 2.3 + 0.7).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(d)).astype(np.float32)
    spec = pl.BlockSpec((8, d), lambda i: (i, 0))
    vspec = pl.BlockSpec((1, d), lambda i: (0, 0))
    want = pl.pallas_call(
        functools.partial(jln._ln_kernel, eps=1e-5), grid=(rows // 8,),
        in_specs=[spec, vspec, vspec], out_specs=spec,
        out_shape=jax.ShapeDtypeStruct((rows, d), jnp.float32), interpret=True,
    )(jnp.asarray(x), jnp.asarray(scale).reshape(1, d), jnp.asarray(bias).reshape(1, d))
    got = tln.fused_layernorm(*to_torch(x, scale, bias), 1e-5)
    assert max_err(got, want) < 1e-5


# --------------------------------------------------------- kernel-free ops
@pytest.mark.parametrize("grid,t", [((30, 45), 13), ((8, 12), 3), ((20, 45), 5)])
def test_rope_tables_match(grid, t):
    crops = get_resize_crop_region_for_grid(grid, 45, 30)
    assert crops == jcrop(grid, 45, 30)
    cos, sin = get_3d_rotary_pos_embed(64, crops, grid, t)
    jcos, jsin = jrope(64, crops, grid, t)
    assert max_err(cos, jcos) < 1e-6 and max_err(sin, jsin) < 1e-6
    x = np.random.default_rng(15).standard_normal((2, cos.shape[0], 64)).astype(np.float32)
    from bindyouravatar_tpu.ops.rope import apply_rotary_emb as japply
    got = apply_rotary_emb(torch.from_numpy(x), cos, sin)
    assert max_err(got, japply(jnp.asarray(x), jcos, jsin)) < 1e-5


def test_timestep_embedding_matches():
    ts = np.array([0.0, 1.0, 499.0, 999.0], np.float32)
    for flip, shift in ((True, 0), (False, 1)):
        got = timestep_embedding(torch.from_numpy(ts), 96, flip, shift)
        want = jtemb(jnp.asarray(ts), 96, flip, shift)
        # arguments reach ~1e3, where one fp32 ulp of the angle (exp of the
        # frequency rounds differently in XLA and torch) is 6.1e-5
        assert max_err(got, want) < 1e-4


def test_patchify_roundtrip_matches():
    x = np.random.default_rng(16).standard_normal((2, 3, 4, 8, 12)).astype(np.float32)
    tok = patchify(torch.from_numpy(x), 2)
    assert max_err(tok, jpatchify(jnp.asarray(x), 2)) == 0.0
    back = unpatchify(tok, (3, 4, 6), 4, 2)
    assert max_err(back, junpatchify(jnp.asarray(np.asarray(tok)), (3, 4, 6), 4, 2)) == 0.0
    assert max_err(back, x) == 0.0


@pytest.mark.parametrize("steps", [2, 5])
def test_scheduler_steps_match(steps):
    """DDIM and DPM++ (2M SDE) steps with numpy-made noise: every step of a
    `steps`-step schedule, first- and second-order branches, last step
    included.  fp32 on both sides; tol 1e-5 on O(1) latents."""
    sched, jsched = Schedule.create(SchedulerConfig()), JSchedule.create(JSchedulerConfig())
    ts = sched.timesteps(steps)
    assert (ts == jsched.timesteps(steps)).all()
    np.testing.assert_allclose(sched.alphas_cumprod, np.asarray(jsched.alphas_cumprod))
    prev_ts = ts - 1000 // steps
    ts_back = np.concatenate([[ts[0]], ts[:-1]])
    rng = np.random.default_rng(17)
    shape = (1, 2, 4, 3, 5)
    sample, out, old, noise = (rng.standard_normal(shape).astype(np.float32) for _ in range(4))
    for i in range(steps):
        # step 0 is first order in the loop (t_back == t there: the
        # multistep ratio would divide by zero on both sides)
        for second in ((False, True) if i > 0 else (False,)):
            got, got_x0 = sched.dpm_step_scan(*to_torch(out, old), int(ts[i]), int(ts_back[i]),
                                              int(prev_ts[i]), *to_torch(sample), second,
                                              *to_torch(noise))
            want, want_x0 = jsched.dpm_step_scan(
                jnp.asarray(out), jnp.asarray(old), jnp.int32(ts[i]), jnp.int32(ts_back[i]),
                jnp.int32(prev_ts[i]), jnp.asarray(sample), jnp.bool_(second),
                jnp.asarray(noise))
            assert max_err(got, want) < 1e-5 and max_err(got_x0, want_x0) < 1e-5
        got = sched.ddim_step(*to_torch(out), int(ts[i]), int(prev_ts[i]), *to_torch(sample))
        want = jsched.ddim_step(jnp.asarray(out), jnp.int32(ts[i]), jnp.int32(prev_ts[i]),
                                jnp.asarray(sample))
        assert max_err(got, want) < 1e-5

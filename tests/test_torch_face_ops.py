"""The face path's kernel ops against the JAX package, on the CPU, in fp32.

Each kernel's plain version (the path a CPU tensor takes) is held against
the JAX package's own plain references (`_spec_attend`, `_pair_spec`,
`_pair_spec2`, `_spec_channel`, `_einsum_attention`) and once against the
Pallas body it replaces, run in interpret mode as the JAX package's tests
run it.  Inputs are made with numpy.  fp32 on both sides, so differences
are summation order only: 1e-5 relative to the output's magnitude.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from bindyouravatar_tpu.ops import packed_attention as jpa
from bindyouravatar_tpu.ops import short_kv_attention as jskv
from bindyouravatar_tpu_torch.models.layers import LayerNorm
from bindyouravatar_tpu_torch.ops import packed_attention as tpa
from bindyouravatar_tpu_torch.ops import short_kv_attention as tskv
from torch_port_utils import max_err, to_torch


def _rel(got, want) -> float:
    return max_err(got, want) / float(np.abs(np.asarray(want)).max())


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# --------------------------------------------------------------------- B2
@pytest.mark.parametrize("n_id,sq,d", [pytest.param(2, 40, 32, id="2-40"),
                                       pytest.param(1, 37, 32, id="1-37"),
                                       pytest.param(3, 19, 32, id="3-19"),
                                       (2, 40, 48), (4, 37, 256)])
def test_b2_plain_matches_spec_attend(n_id, sq, d):
    """Flat-q B2 plain version vs `_spec_attend` on the head-major layout
    (ragged Sq, one to four identities), at D = 32 and at 48 and 256 (the
    card's 64- and 256-column bodies)."""
    b, h, kk = 2, 4, 8
    rng = np.random.default_rng(21)
    q, k, v = _normal(rng, b, sq, h * d), _normal(rng, b, n_id, h, kk, d), _normal(rng, b, n_id, h, kk, d)
    want = jskv._spec_attend(jnp.asarray(q.reshape(b, sq, h, d).transpose(0, 2, 1, 3)),
                             jnp.asarray(k), jnp.asarray(v), 0.17)              # [B,I,H,Sq,D]
    want = np.asarray(want).transpose(0, 1, 3, 2, 4).reshape(b, n_id, sq, h * d)
    got = tskv.short_kv_attention_flat(*to_torch(q, k, v), 0.17)
    assert got.shape == (b, n_id, sq, h * d)
    assert _rel(got, want) < 1e-5


def test_b2_plain_matches_kernel_interpret():
    """B2 plain version vs the TPU body `_kernel` (combine=False, interpret)."""
    g, h, sq, d, n_id, kk, rows = 3, 4, 40, 32, 2, 8, 8
    rng = np.random.default_rng(22)
    q, k, v = _normal(rng, g, h, sq, d), _normal(rng, g, n_id, h, kk, d), _normal(rng, g, n_id, h, kk, d)
    want = pl.pallas_call(
        functools.partial(jskv._kernel, n_id=n_id, sm_scale=0.21, combine=False),
        grid=(g, sq // rows),
        in_specs=[pl.BlockSpec((1, h, rows, d), lambda gi, qi: (gi, 0, qi, 0)),
                  pl.BlockSpec((1, n_id, h, kk, d), lambda gi, qi: (gi, 0, 0, 0, 0)),
                  pl.BlockSpec((1, n_id, h, kk, d), lambda gi, qi: (gi, 0, 0, 0, 0))],
        out_specs=pl.BlockSpec((1, n_id, h, rows, d), lambda gi, qi: (gi, 0, 0, qi, 0)),
        out_shape=jax.ShapeDtypeStruct((g, n_id, h, sq, d), jnp.float32),
        interpret=True)(*map(jnp.asarray, (q, k, v)))
    want = np.asarray(want).transpose(0, 1, 3, 2, 4).reshape(g, n_id, sq, h * d)
    got = tskv.short_kv_attention_flat(
        *to_torch(q.transpose(0, 2, 1, 3).reshape(g, sq, h * d), k, v), 0.21)
    assert _rel(got, want) < 1e-5


# --------------------------------------------------------------------- B4
@pytest.mark.parametrize("m,heads,dh", [(24, 4, 32), (37, 8, 16), (24, 8, 48), (11, 3, 128)])
def test_b4_plain_matches_pair_specs(m, heads, dh):
    """Closed-form B4 plain version vs the einsum softmax spec `_pair_spec`
    and the closed-form spec `_pair_spec2` (q scaled before the dots)."""
    b, c = 2, heads * dh
    rng = np.random.default_rng(23)
    q, k, v = (2.0 * _normal(rng, b, 2, m, c) for _ in range(3))
    args = [jnp.asarray(x) for x in (q, k, v)]
    got = tpa.pair_axis_attention(*to_torch(q, k, v), heads, dh ** -0.5)
    assert _rel(got, jpa._pair_spec(*args, heads, dh ** -0.5)) < 1e-5
    assert _rel(got, jpa._pair_spec2(*args, heads, dh ** -0.5)) < 1e-5


@pytest.mark.parametrize("heads,dh", [(8, 48), (24, 128)])
def test_b4_plain_matches_pair_kernel_interpret_widths(heads, dh):
    """B4 at C = 384 (8 x 48: neither C nor dh a power of two, the Triton
    block's lanes padded) and 3,072 (24 x 128: past the old C <= 1,024, a
    grid column per 4 heads) against the TPU body in interpret mode."""
    b, m = 2, 24
    c = heads * dh
    rng = np.random.default_rng(124)
    q, k, v = (_normal(rng, b, 2, m, c) for _ in range(3))
    spec = pl.BlockSpec((1, 2, 8, c), lambda b_, i: (b_, 0, i, 0))
    want = pl.pallas_call(
        functools.partial(jpa._pair_kernel, heads=heads, sm_scale=dh ** -0.5),
        grid=(b, m // 8), in_specs=[spec, spec, spec], out_specs=spec,
        out_shape=jax.ShapeDtypeStruct((b, 2, m, c), jnp.float32),
        interpret=True)(*map(jnp.asarray, (q, k, v)))
    assert _rel(tpa.pair_axis_attention(*to_torch(q, k, v), heads, dh ** -0.5), want) < 1e-5


def test_b4_plain_matches_pair_kernel_interpret():
    b, m, heads, dh = 2, 24, 4, 32
    c = heads * dh
    rng = np.random.default_rng(24)
    q, k, v = (_normal(rng, b, 2, m, c) for _ in range(3))
    spec = pl.BlockSpec((1, 2, 8, c), lambda b_, i: (b_, 0, i, 0))
    want = pl.pallas_call(
        functools.partial(jpa._pair_kernel, heads=heads, sm_scale=dh ** -0.5),
        grid=(b, m // 8), in_specs=[spec, spec, spec], out_specs=spec,
        out_shape=jax.ShapeDtypeStruct((b, 2, m, c), jnp.float32),
        interpret=True)(*map(jnp.asarray, (q, k, v)))
    assert _rel(tpa.pair_axis_attention(*to_torch(q, k, v), heads, dh ** -0.5), want) < 1e-5


# ----------------------------------------------------------------- B5, B5'
@pytest.mark.parametrize("s", [*range(1, 17), 17, 25, 33, 64])
def test_b5_plain_matches_spec_channel(s):
    """Channel-packed B5 plain version vs `_spec_channel` at every length
    the one-tile body is instantiated for: the temporal STAB's 13 latent
    frames, 3 (the reduced step's, which B5' serves on the card) and the
    rest of 1..16; and on the long body's side of 16: 25 (97 frames), 17
    and 33 (one row into a second and a third tile), 64."""
    m, heads, dh = 20, 4, 16
    rng = np.random.default_rng(25)
    q, k, v = (_normal(rng, m, s, heads * dh) for _ in range(3))
    want = jpa._spec_channel(*map(jnp.asarray, (q, k, v)), heads, dh ** -0.5)
    assert _rel(tpa.tiny_seq_attention(*to_torch(q, k, v), heads, dh ** -0.5), want) < 1e-5


@pytest.mark.parametrize("s,heads,dh", [(13, 16, 32), (13, 8, 48), (13, 4, 128), (25, 4, 128)])
def test_b5_plain_matches_slice_kernel_interpret_widths(s, heads, dh):
    """B5 at the temporal STAB's other head splits (`RouterConfig.
    attn_heads` 16 and 4 over 512 channels; 8 x 48 over 384), 49 frames
    and, at dh 128, 97 (the long body), against `_slice_kernel` in
    interpret mode."""
    m, c = 16, heads * dh
    rng = np.random.default_rng(126)
    q, k, v = (_normal(rng, m, s, c) for _ in range(3))
    spec = pl.BlockSpec((8, s, c), lambda i: (i, 0, 0))
    want = pl.pallas_call(
        functools.partial(jpa._slice_kernel, heads=heads, sm_scale=dh ** -0.5),
        grid=(m // 8,), in_specs=[spec, spec, spec], out_specs=spec,
        out_shape=jax.ShapeDtypeStruct((m, s, c), jnp.float32),
        interpret=True)(*map(jnp.asarray, (q, k, v)))
    assert _rel(tpa.tiny_seq_attention(*to_torch(q, k, v), heads, dh ** -0.5), want) < 1e-5


def test_b5_plain_matches_slice_kernel_interpret():
    m, s, heads, dh = 16, 13, 4, 32
    c = heads * dh
    rng = np.random.default_rng(26)
    q, k, v = (_normal(rng, m, s, c) for _ in range(3))
    spec = pl.BlockSpec((8, s, c), lambda i: (i, 0, 0))
    want = pl.pallas_call(
        functools.partial(jpa._slice_kernel, heads=heads, sm_scale=dh ** -0.5),
        grid=(m // 8,), in_specs=[spec, spec, spec], out_specs=spec,
        out_shape=jax.ShapeDtypeStruct((m, s, c), jnp.float32),
        interpret=True)(*map(jnp.asarray, (q, k, v)))
    assert _rel(tpa.tiny_seq_attention(*to_torch(q, k, v), heads, dh ** -0.5), want) < 1e-5


@pytest.mark.parametrize("s", [2, 3, 7])
def test_b5p_plain_matches_einsum_attention(s):
    """The packed-fold plain version vs `_einsum_attention`, and the fold vs
    the channel-packed B5 plain version on the same memory: one function,
    which is why one kernel serves both."""
    m, heads, dh = 10, 4, 16
    rng = np.random.default_rng(27)
    q, k, v = (_normal(rng, m, s * heads, dh) for _ in range(3))
    want = jpa._einsum_attention(*map(jnp.asarray, (q, k, v)), heads, dh ** -0.5)
    got = tpa.packed_head_attention(*to_torch(q, k, v), heads, dh ** -0.5)
    assert _rel(got, want) < 1e-5
    channel = tpa.tiny_seq_attention(*[t.reshape(m, s, heads * dh) for t in to_torch(q, k, v)],
                                     heads, dh ** -0.5)
    assert _rel(channel.reshape(m, s * heads, dh), want) < 1e-5


@pytest.mark.parametrize("heads,dh", [(16, 32), (8, 48), (4, 128)])
def test_b5p_plain_matches_packed_kernel_interpret_widths(heads, dh):
    """B5' (the packed-head fold, 3 frames) at the STAB's other head splits
    against `_kernel` in interpret mode."""
    m, s = 16, 3
    rng = np.random.default_rng(128)
    q, k, v = (_normal(rng, m, s * heads, dh) for _ in range(3))
    spec = pl.BlockSpec((8, s * heads, dh), lambda i: (i, 0, 0))
    want = pl.pallas_call(
        functools.partial(jpa._kernel, heads=heads, sm_scale=dh ** -0.5),
        grid=(m // 8,), in_specs=[spec, spec, spec], out_specs=spec,
        out_shape=jax.ShapeDtypeStruct((m, s * heads, dh), jnp.float32),
        interpret=True)(*map(jnp.asarray, (q, k, v)))
    assert _rel(tpa.packed_head_attention(*to_torch(q, k, v), heads, dh ** -0.5), want) < 1e-5


def test_b5p_plain_matches_packed_kernel_interpret():
    m, s, heads, dh = 16, 3, 4, 32
    rng = np.random.default_rng(28)
    q, k, v = (_normal(rng, m, s * heads, dh) for _ in range(3))
    spec = pl.BlockSpec((8, s * heads, dh), lambda i: (i, 0, 0))
    want = pl.pallas_call(
        functools.partial(jpa._kernel, heads=heads, sm_scale=dh ** -0.5),
        grid=(m // 8,), in_specs=[spec, spec, spec], out_specs=spec,
        out_shape=jax.ShapeDtypeStruct((m, s * heads, dh), jnp.float32),
        interpret=True)(*map(jnp.asarray, (q, k, v)))
    assert _rel(tpa.packed_head_attention(*to_torch(q, k, v), heads, dh ** -0.5), want) < 1e-5


# ---------------------------------------------------------------- dispatch
def test_face_kernel_wrappers_count_no_cpu_launch():
    """CPU tensors take the plain versions: no wrapper counts a launch."""
    fns = (tskv.short_kv_attention_flat, tpa.pair_axis_attention, tpa.tiny_seq_attention,
           tpa.packed_head_attention)
    before = [fn.launches for fn in fns]
    rng = np.random.default_rng(29)
    tskv.short_kv_attention_flat(*to_torch(_normal(rng, 1, 8, 256), _normal(rng, 1, 2, 2, 32, 128),
                                           _normal(rng, 1, 2, 2, 32, 128)), 0.1)
    tpa.pair_axis_attention(*to_torch(*(_normal(rng, 1, 2, 8, 128) for _ in range(3))), 2, 0.1)
    for s in (13, 3):
        tpa.tiny_seq_attention(*to_torch(*(_normal(rng, 4, s, 128) for _ in range(3))), 2, 0.1)
    assert [fn.launches for fn in fns] == before


def test_face_kernel_wrappers_raise_off_cpu():
    """A tensor that is not on the CPU never takes a plain version (here:
    meta tensors, which no kernel takes)."""
    meta = lambda *shape: torch.empty(shape, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        tskv.short_kv_attention_flat(meta(2, 64, 256), meta(2, 2, 2, 32, 128),
                                     meta(2, 2, 2, 32, 128), 0.1)
    with pytest.raises(ValueError):
        tpa.pair_axis_attention(meta(2, 2, 64, 512), meta(2, 2, 64, 512), meta(2, 2, 64, 512),
                                8, 0.125)
    for s in (13, 3):          # B5, and B5' through the S < 8 dispatch
        with pytest.raises(ValueError):
            tpa.tiny_seq_attention(meta(64, s, 512), meta(64, s, 512), meta(64, s, 512), 8, 0.125)
    with pytest.raises(ValueError):
        tpa.packed_head_attention(meta(64, 16, 64), meta(64, 16, 64), meta(64, 16, 64), 8, 0.125)


@pytest.mark.parametrize("d,body", [(8, 64), (16, 64), (32, 64), (48, 64), (64, 64), (80, 128),
                                    (128, 128), (136, 256), (256, 256)])
def test_short_kv_body_rule(d, body):
    """The short-KV kernels' shape rule: a head of D columns runs on the
    narrowest of the 64-, 128- and 256-column bodies that holds it (the
    tensor maps read the columns past D as zeros); on meta tensors (which
    no kernel takes) each wrapper passes the rule and then refuses the
    device."""
    assert tskv.short_kv_body(d) == body
    meta = lambda *shape: torch.empty(shape, device="meta", dtype=torch.bfloat16)
    kv, w = meta(1, 2, 3, 32, d), meta(1, 64, 2)
    for fn, args in ((tskv.short_kv_attention_combined_flat, (meta(1, 64, 3 * d), kv, kv, w)),
                     (tskv.short_kv_attention_flat, (meta(1, 64, 3 * d), kv, kv)),
                     (tskv.short_kv_attention_combined_qmajor, (meta(1, 64, 3, d), kv, kv, w)),
                     (tskv.short_kv_attention, (meta(1, 3, 64, d), kv, kv))):
        with pytest.raises(ValueError, match="contiguous bf16 CUDA"):
            fn(*args, 0.1)


def test_short_kv_refusals_name_their_item():
    """Past the rule each short-KV wrapper raises on a non-CPU tensor,
    naming the ROADMAP.md queue B item that holds the case: D % 8 != 0
    (item 3), D > 256 (item 4).  Any K and I pass the rule
    (`test_torch_short_kv_tokens.py` holds them)."""
    meta = lambda *shape: torch.empty(shape, device="meta", dtype=torch.bfloat16)
    for d, k_tokens, n_id, item in ((12, 32, 2, 3), (264, 32, 2, 4)):
        kv, w = meta(1, n_id, 2, k_tokens, d), meta(1, 64, n_id)
        for fn, args in ((tskv.short_kv_attention_combined_flat, (meta(1, 64, 2 * d), kv, kv, w)),
                         (tskv.short_kv_attention_flat, (meta(1, 64, 2 * d), kv, kv)),
                         (tskv.short_kv_attention_qmajor, (meta(1, 64, 2, d), kv, kv)),
                         (tskv.short_kv_attention_combined, (meta(1, 2, 64, d), kv, kv, w))):
            with pytest.raises(ValueError, match=f"ROADMAP.md queue B item {item}"):
                fn(*args, 0.1)


def test_pair_kernel_launch_shape():
    """B4's launch shape (`pair_blocks`): the head width and the heads a
    program takes padded to powers of two, about 4,096 elements a tile;
    past JAX's 128 heads a CUDA call raises naming ROADMAP.md C4 (JAX's
    kernel computes those heads wrong)."""
    assert tpa.pair_blocks(512, 8) == (64, 8, 8)          # the 5B's 8 x 64: as before
    assert tpa.pair_blocks(384, 8) == (64, 8, 8)          # 8 x 48: 16 lanes a head masked
    assert tpa.pair_blocks(3072, 24) == (128, 32, 1)
    assert tpa.pair_blocks(200, 25) == (8, 32, 16)
    for c, heads in ((512, 4), (512, 16), (3072, 24), (200, 25), (1024, 128), (384, 8)):
        dp, hb, block_m = tpa.pair_blocks(c, heads)
        assert dp >= c // heads > dp // 2 and hb * dp * block_m <= 4096 and hb <= 2 * heads
    meta = torch.empty((1, 2, 64, 129 * 8), device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="ROADMAP.md C4"):
        tpa.pair_axis_attention(meta, meta, meta, 129, 0.1)


def test_fused_layernorm_dispatch_by_width():
    """`LayerNorm(fused=True)` takes kernel B6 only for widths that are
    multiples of 128 (the JAX shape rule): off the CPU a width of 96 takes
    the plain math, a width of 128 goes to the kernel's wrapper (which
    raises for meta tensors)."""
    for dim, kernel in ((96, False), (128, True)):
        norm = LayerNorm(dim, fused=True).to("meta")
        x = torch.empty((4, dim), device="meta", dtype=torch.bfloat16)
        if kernel:
            with pytest.raises(ValueError):
                norm(x)
        else:
            assert norm(x).shape == (4, dim)

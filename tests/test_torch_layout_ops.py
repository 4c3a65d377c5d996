"""The general-layout attention ops against the JAX package, on the CPU, in
fp32.

Each plain version (the path a CPU tensor takes) is held against the
Pallas body its kernel replaces, run in interpret mode as the JAX
package's own tests run it: B11 through `_fwd_impl(interpret=True,
save_residuals=True)`, the fused B12 + B13 backward through
`_bwd_impl(interpret=True)` (the two-kernel TPU backward) fed that
forward's output and LSE, B14 and B2c (and B2h, B2's body in the
head-major layout) through `pl.pallas_call` of `_kernel_qmajor` and
`_kernel`.  Both layouts, head dims 64 and 128, with
and without RoPE and the fused QK LayerNorm, and a ragged sequence (200
rows in 128-row blocks, a masked kv tail).  Then the entry points: the
port's `flash_attention(layout=...)` autograd against `jax.vjp` of the
JAX `_flash` custom vjp (interpret) and of `attention(layout=...)`, and
the four JAX-layout short-KV entry points, values and gradients.  Inputs
are made with numpy.  fp32 on both sides: 1e-5 relative to each output's
magnitude for values and the LSE, 1e-4 for gradients (sums over the
sequence in another order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from bindyouravatar_tpu.ops import attention as jattn
from bindyouravatar_tpu.ops import flash_attention as jfa
from bindyouravatar_tpu.ops import short_kv_attention as jskv
from bindyouravatar_tpu.ops.rope import get_3d_rotary_pos_embed as jrope
from bindyouravatar_tpu_torch.ops import attention as tattn
from bindyouravatar_tpu_torch.ops import flash_attention as tfa
from bindyouravatar_tpu_torch.ops import short_kv_attention as tskv
from torch_port_utils import max_err, to_torch


def _rel(got, want) -> float:
    return max_err(got, want) / float(np.abs(np.asarray(want)).max())


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ----------------------------------------------------------- B11, B12 + B13
def _case(layout, d, rope, ln, ragged, h=2, seed=0):
    """q/k/v in `layout`, S = 200 (ragged: kv_len 190) or 256; RoPE over
    rows 8..187 (3 x 6 x 10 video tokens after 8 text tokens); QK-LN
    affines at realistic scale."""
    s, b, text_len = (200, 1, 8) if ragged else (256, 1, 8)
    rng = np.random.default_rng(seed)
    shape = (b, h, s, d) if layout == "bhsd" else (b, s, h, d)
    q, k, v = (_normal(rng, *shape) for _ in range(3))
    c = dict(layout=layout, d=d, s=s, h=h, kv_len=190 if ragged else s, q=q, k=k, v=v,
             rope=None, text_len=text_len, ln=None, do=_normal(rng, *shape))
    if rope:
        cos, sin = (np.asarray(t) for t in jrope(d, ((0, 0), (6, 10)), (6, 10), 3))
        c["rope"] = (cos, sin)
    if ln:
        c["ln"] = tuple(_normal(rng, d) * 0.1 + m for m in (1.0, 0.0, 1.0, 0.0))
    return c


def _jax_rope(c):
    """The JAX kernels' full-length tables: identity rows outside the
    video rows (what `flash_attention` builds before `_fwd_impl`)."""
    if c["rope"] is None:
        return None
    cos, sin = c["rope"]
    d, s, t0 = c["d"], c["s"], c["text_len"]
    tail = s - t0 - cos.shape[0]
    full = lambda t, fill: jnp.concatenate([jnp.full((t0, d), fill), jnp.asarray(t),
                                            jnp.full((tail, d), fill)])
    return full(cos, 1.0), full(sin, 0.0)


def _port_kw(c):
    rope = None if c["rope"] is None else tuple(to_torch(*c["rope"]))
    return dict(layout=c["layout"], kv_len=c["kv_len"], rope=rope, rope_start=c["text_len"])


def _jax_fwd(c):
    qk_norm = None if c["ln"] is None else tuple(jnp.asarray(a) for a in c["ln"])
    o, lse = jfa._fwd_impl(*(jnp.asarray(c[n]) for n in "qkv"), _jax_rope(c), c["d"] ** -0.5,
                           c["kv_len"], 128, 128, True, save_residuals=True,
                           bshd=c["layout"] == "bshd", qk_norm=qk_norm)
    return np.asarray(o), np.asarray(lse)[..., 0]


LAYOUT_CASES = [("bhsd", 64, True, False, True), ("bshd", 64, True, True, False),
                ("bhsd", 128, True, True, True), ("bshd", 128, True, False, True),
                ("bshd", 64, False, False, True), ("bhsd", 128, False, True, False)]


@pytest.mark.parametrize("layout,d,rope,ln,ragged", LAYOUT_CASES)
def test_b11_plain_matches_fwd_kernel_interpret(layout, d, rope, ln, ragged):
    """B11's plain forward (output and LSE) vs `_fwd_impl` in interpret
    mode (the `_fwd_kernel` body with `save_residuals`)."""
    c = _case(layout, d, rope, ln, ragged)
    o_want, lse_want = _jax_fwd(c)
    ln_t = None if c["ln"] is None else tuple(to_torch(*c["ln"]))
    o, lse = tfa.flash_attention_fwd(*to_torch(c["q"], c["k"], c["v"]), qk_norm=ln_t,
                                     **_port_kw(c))
    assert o.shape == c["q"].shape and lse.shape == (1, c["h"], c["s"])
    assert _rel(o, o_want) < 1e-5
    assert _rel(lse, lse_want) < 1e-5


BWD_CASES = [cs for cs in LAYOUT_CASES if not cs[3]] + [("bshd", 64, True, False, False)]


@pytest.mark.parametrize("layout,d,rope,ln,ragged", BWD_CASES)
def test_b12_b13_plain_match_bwd_kernels_interpret(layout, d, rope, ln, ragged):
    """The B12 + B13 entry's plain path (dq, dk, dv) vs `_bwd_impl` in
    interpret mode (`_dkv_kernel`, `_dq_kernel`), both fed `_fwd_impl`'s
    output and LSE (padded to the backward's blocks as `_flash_bwd` does)."""
    c = _case(layout, d, rope, ln, ragged, seed=1)
    bshd = layout == "bshd"
    o, lse4 = jfa._fwd_impl(*(jnp.asarray(c[n]) for n in "qkv"), _jax_rope(c), d ** -0.5,
                            c["kv_len"], 128, 128, True, save_residuals=True, bshd=bshd)
    s_pad = -(-c["s"] // 128) * 128
    lse_pad = jnp.pad(lse4, [(0, 0), (0, 0), (0, s_pad - c["s"]), (0, 0)],
                      constant_values=-jfa.NEG_INF)
    dq_w, dk_w, dv_w = jfa._bwd_impl(*(jnp.asarray(c[n]) for n in "qkv"), o, lse_pad,
                                     jnp.asarray(c["do"]), _jax_rope(c), d ** -0.5, c["kv_len"],
                                     128, 128, True, bshd=bshd)
    args = to_torch(c["q"], c["k"], c["v"], np.asarray(o), c["do"],
                    np.asarray(lse4)[..., 0])
    dq, dk, dv = tfa.flash_attention_bwd(*args, **_port_kw(c))
    for got, want in ((dq, dq_w), (dk, dk_w), (dv, dv_w)):
        assert got.shape == c["q"].shape
        assert _rel(got, want) < 1e-4


@pytest.mark.parametrize("layout,d,rope,ln,ragged", BWD_CASES)
def test_fused_bwd_entry_is_the_plain_pair(layout, d, rope, ln, ragged):
    """The fused backward's entry point on CPU tensors returns exactly
    (`flash_attention_dq_plain`, `flash_attention_dkv_plain`), the pair the
    test above holds against `_bwd_impl`."""
    c = _case(layout, d, rope, ln, ragged, seed=2)
    o, lse = tfa.flash_attention_fwd(*to_torch(c["q"], c["k"], c["v"]), **_port_kw(c))
    args = (*to_torch(c["q"], c["k"], c["v"]), o, torch.from_numpy(c["do"]), lse)
    got = tfa.flash_attention_bwd(*args, **_port_kw(c))
    parts = (tfa.flash_attention_dq_plain(*args, **_port_kw(c)),
             *tfa.flash_attention_dkv_plain(*args, **_port_kw(c)))
    for g, p in zip(got, parts):
        assert g.shape == c["q"].shape and torch.equal(g, p)


@pytest.mark.parametrize("layout,d,ragged,h", [("bhsd", 64, True, 2), ("bshd", 64, True, 3),
                                               ("bshd", 128, False, 2)])
def test_flash_attention_layout_grads_match_jax(layout, d, ragged, h):
    """The port's `flash_attention(layout=...)` (values and q/k/v
    gradients through autograd) vs `jax.vjp` of the JAX `_flash` custom
    vjp (interpret mode; 3 heads of 64 in bshd take its two-kernel
    backward) and of `attention(layout=...)` (its XLA path)."""
    c = _case(layout, d, True, False, ragged, h=h, seed=2)
    bshd = layout == "bshd"
    cos_j, sin_j = _jax_rope(c)
    jq = [jnp.asarray(c[n]) for n in "qkv"]
    f_flash = lambda q, k, v: jfa._flash(q, k, v, cos_j, sin_j, d ** -0.5, c["kv_len"], 128, 128,
                                         True, bshd)
    rope_j = tuple(jnp.asarray(t) for t in c["rope"])
    f_attn = lambda q, k, v: jattn.attention(q, k, v, kv_len=c["kv_len"], rope=rope_j,
                                             rope_start=c["text_len"], layout=layout)
    qkv = [t.requires_grad_() for t in to_torch(c["q"], c["k"], c["v"])]
    out = tfa.flash_attention(*qkv, **_port_kw(c))
    grads = torch.autograd.grad(out, qkv, torch.from_numpy(c["do"]))
    out2 = tattn.attention(*[t.detach() for t in qkv], **_port_kw(c))
    for f in (f_flash, f_attn):
        want, vjp = jax.vjp(f, *jq)
        assert _rel(out, want) < 1e-5 and _rel(out2, want) < 1e-5
        for g, w in zip(grads, vjp(jnp.asarray(c["do"]))):
            assert _rel(g, w) < 1e-4


def test_layout_autograd_function_matches_autograd_of_plain_forward():
    """`_FlashLayout` (the CUDA path's wiring: B11 forward with the LSE,
    the fused B12 + B13 backward computing delta) run on CPU tensors, where
    each part takes its plain version, against autograd through the plain
    forward."""
    c = _case("bshd", 64, True, False, True, h=3, seed=3)
    kw = _port_kw(c)
    grads = []
    for fn in (lambda *a: tfa._FlashLayout.apply(*a, "bshd", None, kw["kv_len"], kw["rope"],
                                                 kw["rope_start"]),
               lambda *a: tfa.flash_attention_fwd_plain(*a, "bshd", kv_len=kw["kv_len"],
                                                        rope=kw["rope"],
                                                        rope_start=kw["rope_start"])[0]):
        qkv = [t.requires_grad_() for t in to_torch(c["q"], c["k"], c["v"])]
        grads.append(torch.autograd.grad(fn(*qkv), qkv, torch.from_numpy(c["do"])))
    for g, want in zip(*grads):
        assert _rel(g, want.numpy()) < 1e-5


def test_fused_qk_norm_attention_matches_jax():
    """`attention(layout=..., qk_norm=...)` (the inference form, LN fused
    into B11) vs JAX `attention` with the same arguments, both layouts."""
    for layout in ("bhsd", "bshd"):
        c = _case(layout, 64, True, True, True, seed=4)
        want = jattn.attention(*(jnp.asarray(c[n]) for n in "qkv"), kv_len=c["kv_len"],
                               rope=tuple(jnp.asarray(t) for t in c["rope"]),
                               rope_start=c["text_len"], layout=layout,
                               qk_norm=tuple(jnp.asarray(a) for a in c["ln"]))
        got = tattn.attention(*to_torch(c["q"], c["k"], c["v"]), **_port_kw(c),
                              qk_norm=tuple(to_torch(*c["ln"])))
        assert _rel(got, want) < 1e-5


# -------------------------------------------------------- B14, B2c, B2h
def _skv(d, seed, g=2, h=3, sq=40, n_id=2, kk=32):
    rng = np.random.default_rng(seed)
    q = _normal(rng, g, h, sq, d)
    k, v = (_normal(rng, g, n_id, h, kk, d) for _ in range(2))
    w = rng.uniform(size=(g, sq, n_id)).astype(np.float32)
    return q, k, v, w


@pytest.mark.parametrize("qmajor", [False, True])
@pytest.mark.parametrize("combine", [False, True])
@pytest.mark.parametrize("d", [48, 64, 128, 256])
def test_short_kv_plain_matches_kernels_interpret(qmajor, combine, d):
    """B14 (`_kernel_qmajor`), B2c (`_kernel`, combine) and B2h (`_kernel`,
    per identity, head-major): plain versions vs the
    Pallas bodies in interpret mode (8-row query blocks), at the head dims
    of the card's three bodies (48 rides the 64 one)."""
    q, k, v, w = _skv(d, seed=10 + d + 2 * combine + qmajor)
    sm = 0.21
    if qmajor:
        q = np.ascontiguousarray(q.transpose(0, 2, 1, 3))        # [G, Sq, H, D]
        g, sq, h, _ = q.shape
        qspec = pl.BlockSpec((1, 8, h, d), lambda gi, qi: (gi, qi, 0, 0))
        body = jskv._kernel_qmajor
        out_c, out_i = (g, sq, h, d), (g, 2, sq, h, d)
        ospec_c = qspec
        ospec_i = pl.BlockSpec((1, 2, 8, h, d), lambda gi, qi: (gi, 0, qi, 0, 0))
        plain = (tskv.short_kv_attention_combined_qmajor_plain if combine
                 else tskv.short_kv_attention_qmajor_plain)
    else:
        g, h, sq, _ = q.shape
        qspec = pl.BlockSpec((1, h, 8, d), lambda gi, qi: (gi, 0, qi, 0))
        body = jskv._kernel
        out_c, out_i = (g, h, sq, d), (g, 2, h, sq, d)
        ospec_c = qspec
        ospec_i = pl.BlockSpec((1, 2, h, 8, d), lambda gi, qi: (gi, 0, 0, qi, 0))
        plain = (tskv.short_kv_attention_combined_plain if combine
                 else tskv.short_kv_attention_plain)
    kvspec = pl.BlockSpec((1, 2, h, 32, d), lambda gi, qi: (gi, 0, 0, 0, 0))
    in_specs, inputs = [qspec, kvspec, kvspec], [q, k, v]
    if combine:
        in_specs.append(pl.BlockSpec((1, 8, 2), lambda gi, qi: (gi, qi, 0)))
        inputs.append(w)
    want = pl.pallas_call(
        functools.partial(body, n_id=2, sm_scale=sm, combine=combine),
        grid=(g, sq // 8), in_specs=in_specs, out_specs=ospec_c if combine else ospec_i,
        out_shape=jax.ShapeDtypeStruct(out_c if combine else out_i, jnp.float32),
        interpret=True)(*map(jnp.asarray, inputs))
    got = plain(*to_torch(*inputs), sm)
    assert got.shape == want.shape
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("name,combine,qmajor", [
    ("short_kv_attention", False, False), ("short_kv_attention_combined", True, False),
    ("short_kv_attention_qmajor", False, True),
    ("short_kv_attention_combined_qmajor", True, True)])
def test_short_kv_entry_points_match_jax(name, combine, qmajor):
    """The four JAX-layout entry points, values and the gradients of q, k,
    v (and w) through autograd, vs the JAX functions of the same name
    (custom vjps whose backward is the spec's vjp), ragged Sq = 37."""
    q, k, v, w = _skv(64, seed=20 + 2 * combine + qmajor, sq=37)
    if qmajor:
        q = np.ascontiguousarray(q.transpose(0, 2, 1, 3))
    args = [q, k, v] + ([w] if combine else [])
    rng = np.random.default_rng(30)
    jf = getattr(jskv, name)
    want, vjp = jax.vjp(lambda *a: jf(*a, 0.19), *map(jnp.asarray, args))
    gout = _normal(rng, *want.shape)
    leaves = [t.requires_grad_() for t in to_torch(*args)]
    got = getattr(tskv, name)(*leaves, 0.19)
    assert _rel(got, want) < 1e-5
    for g, wg in zip(torch.autograd.grad(got, leaves, torch.from_numpy(gout)),
                     vjp(jnp.asarray(gout))):
        assert _rel(g, wg) < 1e-4


def test_short_kv_flat_and_head_major_agree():
    """`short_kv_attention_flat` (B2 on the flat projection) and the JAX-
    layout `short_kv_attention` compute one function on two layouts."""
    q, k, v, _ = _skv(128, seed=40, h=2)
    g, h, sq, d = q.shape
    flat = tskv.short_kv_attention_flat(
        *to_torch(q.transpose(0, 2, 1, 3).reshape(g, sq, h * d), k, v), 0.1)
    head = tskv.short_kv_attention(*to_torch(q, k, v), 0.1)              # [G, I, H, Sq, D]
    assert torch.allclose(flat, head.transpose(2, 3).reshape(g, 2, sq, h * d), atol=1e-6)


# ---------------------------------------------------------------- dispatch
LAYOUT_FNS = (tfa.flash_attention_fwd, tfa.flash_attention_bwd, tskv.short_kv_attention_qmajor,
              tskv.short_kv_attention_combined, tskv.short_kv_attention,
              tskv.short_kv_attention_flat)


def test_layout_wrappers_count_no_cpu_launch():
    """CPU tensors take the plain versions: no wrapper counts a launch."""
    before = [fn.launches for fn in LAYOUT_FNS]
    c = _case("bshd", 64, True, False, True, seed=5)
    qkv = [t.requires_grad_() for t in to_torch(c["q"], c["k"], c["v"])]
    torch.autograd.grad(tfa.flash_attention(*qkv, **_port_kw(c)).sum(), qkv)
    q, k, v, w = to_torch(*_skv(64, seed=41))
    tskv.short_kv_attention(q, k, v, 0.1)
    tskv.short_kv_attention_combined(q, k, v, w, 0.1)
    qm = q.transpose(1, 2).contiguous()
    tskv.short_kv_attention_qmajor(qm, k, v, 0.1)
    tskv.short_kv_attention_combined_qmajor(qm, k, v, w, 0.1)
    assert [fn.launches for fn in LAYOUT_FNS] == before


def test_layout_wrappers_raise_off_cpu():
    """A tensor that is not on the CPU never takes a plain version (here:
    meta tensors, which no kernel takes); an unknown layout raises."""
    meta = lambda *shape: torch.empty(shape, device="meta", dtype=torch.bfloat16)
    x = meta(1, 4, 128, 64)
    lse = torch.empty((1, 4, 128), device="meta")
    for layout in ("bhsd", "bshd"):
        with pytest.raises(ValueError):
            tfa.flash_attention(x, x, x, layout=layout)
        with pytest.raises(ValueError):
            tfa.flash_attention_bwd(x, x, x, x, x, lse, layout)
    kv, w = meta(1, 2, 4, 32, 64), meta(1, 128, 2)
    for fn, args in ((tskv.short_kv_attention, (x, kv, kv)),
                     (tskv.short_kv_attention_combined, (x, kv, kv, w)),
                     (tskv.short_kv_attention_qmajor, (x, kv, kv)),
                     (tskv.short_kv_attention_combined_qmajor, (x, kv, kv, w))):
        with pytest.raises(ValueError):
            fn(*args, 0.1)
    with pytest.raises(ValueError):
        tattn.attention(*to_torch(*_skv(64, seed=42)[:3]), layout="hsd")

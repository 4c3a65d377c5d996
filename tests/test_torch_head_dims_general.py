"""The flash kernels and the head LayerNorm at every head dim the JAX
kernels take (D % 8 == 0 up to 256), against the JAX package on the CPU,
fp32.

* B11's plain forward and the fused B12 + B13's plain backward against
  `jax.vjp` of the JAX `_flash` custom vjp in interpret mode (`_fwd_kernel`,
  and `_dkv_kernel` + `_dq_kernel` or the combined backward), bhsd and
  bshd, at D = 8, 16, 48, 96 and 256: RoPE from row 8 (rotate-half tables
  of drawn angles), 200 rows (not a multiple of the 128-row block) with kv
  rows >= 190 masked.  Output and the three gradients within relative L2
  1e-5 (fp32 on both sides, sums in another order).
* B1's plain version (QK-LN and RoPE fused) and B7's plain forward and
  backward against the interpret-mode flat kernels (`_fwd_flat_t_impl`,
  `_fwd_flat_impl`, `jax.vjp` of `flash_attention(layout="flat")`) at 8
  heads of 16 and 2 heads of 256; at 2 x 48 and 2 x 96, where JAX's flat
  kernels assert, the port's flat check raises.
* `head_layernorm_plain` and its backward against JAX's `head_layernorm`
  (its kernel, or at C // dh > 128 its XLA math) and `jax.vjp` of it at dh
  16 (C = 3,072: 192 heads), 48, 96 and 256, relative L2 1e-5.
* The dispatch on meta tensors: the DiT's joint attention asks B1 only at
  head dims 32, 64 and 128 where the heads pack, else B10 and then B7 or
  B11; the refusals name their ROADMAP entries; the STAB attention at dh
  256 against JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bindyouravatar_tpu.models import router as jrouter
from bindyouravatar_tpu.ops import flash_attention as jfa
from bindyouravatar_tpu.ops import layernorm as jln
from bindyouravatar_tpu_torch.convert import jax_params_to_torch
from bindyouravatar_tpu_torch.models import layers as tlayers
from bindyouravatar_tpu_torch.models import router as trouter
from bindyouravatar_tpu_torch.ops import flash_attention as tfa
from bindyouravatar_tpu_torch.ops import layernorm as tln
from torch_port_utils import max_err, realistic, to_torch

S, KV_LEN, TEXT_LEN, ROPE_ROWS = 200, 190, 8, 150


@pytest.fixture(autouse=True, scope="module")
def _threads():
    """One torch thread: under the 6-worker suite the plain forward's first
    call in a test gave outputs ~2e-5 off (relative L2) at 2 threads, and
    the same call again gave the 5e-7 of a quiet run; these shapes are
    small."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel_l2(got, want) -> float:
    g = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want, np.float64)
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


def _rel(got, want) -> float:
    return max_err(got, want) / float(np.abs(np.asarray(want)).max())


def _tables(rng, d):
    """Rotate-half RoPE tables [ROPE_ROWS, d] (angles drawn, both halves
    alike, as the 3D tables are) and the JAX kernels' full-length ones
    (identity rows outside [TEXT_LEN, TEXT_LEN + ROPE_ROWS))."""
    phi = rng.uniform(0.0, 3.0, (ROPE_ROWS, d // 2))
    ang = np.concatenate([phi, phi], 1)
    cos, sin = np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)
    tail = S - TEXT_LEN - ROPE_ROWS
    full = lambda t, fill: jnp.asarray(np.concatenate(
        [np.full((TEXT_LEN, d), fill, np.float32), t, np.full((tail, d), fill, np.float32)]))
    return (cos, sin), (full(cos, 1.0), full(sin, 0.0))


# ----------------------------------------------------------- B11, B12 + B13
@pytest.fixture(scope="module")
def layout_runs():
    """layout, d -> (inputs, the port's tables, JAX's output and gradients):
    JAX's interpret-mode references, computed once for the module."""
    cache = {}

    def run(layout, d):
        if (layout, d) not in cache:
            rng = np.random.default_rng(d + (layout == "bshd"))
            shape = (1, 2, S, d) if layout == "bhsd" else (1, S, 2, d)
            q, k, v, do = (rng.standard_normal(shape).astype(np.float32) for _ in range(4))
            rope, (cos_j, sin_j) = _tables(rng, d)
            f = lambda q, k, v: jfa._flash(q, k, v, cos_j, sin_j, d ** -0.5, KV_LEN, 128, 128,
                                           True, layout == "bshd")
            o, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
            grads = vjp(jnp.asarray(do))
            cache[layout, d] = ((q, k, v, do), rope, np.asarray(o), [np.asarray(g) for g in grads])
        return cache[layout, d]

    return run


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("d", [8, 16, 48, 96, 256])
def test_b11_b12_b13_plain_match_jax_interpret(layout, d, layout_runs):
    """B11's plain forward and the fused B12 + B13's plain backward (what a
    CPU tensor takes) against the JAX custom vjp's interpret-mode kernels:
    the output and dq, dk, dv, RoPE from row 8, a masked kv tail."""
    (q, k, v, do), rope, o_want, grads_want = layout_runs(layout, d)
    kw = dict(layout=layout, kv_len=KV_LEN, rope=tuple(to_torch(*rope)), rope_start=TEXT_LEN)
    qt, kt, vt = to_torch(q, k, v)
    o, lse = tfa.flash_attention_fwd(qt, kt, vt, **kw)
    assert _rel_l2(o, o_want) < 1e-5
    got = tfa.flash_attention_bwd(qt, kt, vt, o, torch.from_numpy(do), lse, **kw)
    for g, w in zip(got, grads_want):
        assert g.shape == qt.shape and _rel_l2(g, w) < 1e-5


# ------------------------------------------------------------ flat B1 / B7
def _flat_case(h, d, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((1, S, h * d)).astype(np.float32) for _ in range(3))
    rope, full = _tables(rng, d)
    norm = [(m + 0.1 * rng.standard_normal(d)).astype(np.float32) for m in (1.0, 0.0, 1.0, 0.0)]
    return q, k, v, rope, full, norm


@pytest.mark.parametrize("h,d", [(8, 16), (2, 256)])
def test_flat_plain_match_flat_kernels_interpret(h, d):
    """B1's plain version (QK-LN + RoPE) against `_fwd_flat_t_impl`, B7's
    plain forward (output, LSE) and backward against `_fwd_flat_impl` and
    `jax.vjp` of the `_flash_flat` custom vjp, interpret mode, at heads
    that pack into 128 lanes (hpb 8 and 1)."""
    q, k, v, rope, full, norm = _flat_case(h, d, 60 + d)
    qj, kj, vj = map(jnp.asarray, (q, k, v))
    want_b1 = jfa._fwd_flat_t_impl(qj, kj, jnp.swapaxes(vj, 1, 2), h, full, d ** -0.5, KV_LEN,
                                   128, 128, True, qk_norm=tuple(map(jnp.asarray, norm)))
    qt, kt, vt = to_torch(q, k, v)
    rope_t = tuple(to_torch(*rope))
    got_b1 = tfa.flash_attention(qt, kt, vt, h, kv_len=KV_LEN, rope=rope_t, rope_start=TEXT_LEN,
                                 qk_norm=tuple(to_torch(*norm)))
    assert _rel_l2(got_b1[:, :KV_LEN], np.asarray(want_b1)[:, :KV_LEN]) < 1e-5

    def flat(q, k, v):
        return jfa.flash_attention(q, k, v, layout="flat", heads=h, kv_len=KV_LEN,
                                   rope=tuple(map(jnp.asarray, rope)), rope_start=TEXT_LEN,
                                   block_q=128, block_k=128, interpret=True)

    o_want, vjp = jax.vjp(flat, qj, kj, vj)
    _, lse_want = jfa._fwd_flat_impl(qj, kj, vj, h, full, d ** -0.5, KV_LEN, 128, 128, True,
                                     save_residuals=True)
    o, lse = tfa.flash_attention_flat_fwd(qt, kt, vt, h, kv_len=KV_LEN, rope=rope_t,
                                          rope_start=TEXT_LEN)
    assert _rel_l2(o, o_want) < 1e-5
    assert max_err(lse, np.asarray(lse_want).reshape(1, h, S)) < 1e-4
    do = np.random.default_rng(d).standard_normal(o.shape).astype(np.float32)
    do[:, KV_LEN:] = 0.0
    dot = torch.from_numpy(do)
    got = tfa.flash_attention_flat_bwd(qt, kt, vt, dot, lse, tfa.attention_delta(o, dot, h), h,
                                       kv_len=KV_LEN, rope=rope_t, rope_start=TEXT_LEN)
    for g, w in zip(got, vjp(jnp.asarray(do))):
        assert _rel_l2(g, w) < 1e-5


@pytest.mark.parametrize("d", [48, 96])
def test_flat_check_refuses_where_jax_asserts(d):
    """2 heads of 48 and of 96 do not pack into 128 lanes: JAX's flat
    kernels assert (`ops/flash_attention.py:490`) and the port's flat
    check raises, naming that rule, before a kernel is asked; the bshd
    kernels' check takes the same heads."""
    with pytest.raises(AssertionError):
        jfa.flash_attention(*(jnp.zeros((1, 256, 2 * d)) for _ in range(3)), layout="flat",
                            heads=2, interpret=True)
    with pytest.raises(ValueError, match=f"2 heads of {d} do not pack.*flash_attention.py:490"):
        tfa.check_flat_head_dim(2 * d, 2)
    meta = torch.empty((1, 1024, 2 * d), device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="do not pack"):
        tfa.flash_attention_flat_fwd(meta, meta, meta, 2)
    tfa.check_head_dim(d, "bshd")


# ---------------------------------------------------------------- B10
@pytest.mark.parametrize("dh,c", [(16, 3072), (48, 384), (96, 384), (256, 512)])
def test_head_layernorm_plain_matches_jax(dh, c):
    """`head_layernorm_plain` and `head_layernorm_bwd_plain` against JAX's
    `head_layernorm` and its vjp, 37 rows; at dh 16 the row holds 192
    heads (past JAX's kernel rule, `C // dh <= 128`: its XLA math)."""
    rng = np.random.default_rng(dh)
    x = (0.7 + 2.3 * rng.standard_normal((37, c))).astype(np.float32)
    g = rng.standard_normal((37, c)).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(dh)).astype(np.float32)
    b = (0.1 * rng.standard_normal(dh)).astype(np.float32)
    y_want, vjp = jax.vjp(lambda x, w, b: jln.head_layernorm(x, w, b), *map(jnp.asarray, (x, w, b)))
    xt, wt, bt, gt = to_torch(x, w, b, g)
    assert _rel_l2(tln.head_layernorm_plain(xt, wt, bt), y_want) < 1e-5
    for got, want in zip(tln.head_layernorm_bwd_plain(xt, wt, gt), vjp(jnp.asarray(g))):
        assert _rel_l2(got, want) < 1e-5


# ------------------------------------------------------------ dispatch
@pytest.mark.parametrize("heads,d,fuse,want", [
    (2, 64, True, "B1"), (4, 32, True, "B1"), (3, 128, True, "B1"),
    (8, 16, True, "B10 flat"), (2, 256, True, "B10 flat"), (6, 16, True, "B10 bshd"),
    (47, 64, True, "B10 bshd"), (3, 32, True, "B10 bshd"), (12, 256, False, "B10 flat"),
    (189, 16, False, "B10 bshd"), (6, 48, False, "B10 flat")])
def test_joint_attention_asks_b1_only_at_jax_head_dims(heads, d, fuse, want, monkeypatch):
    """On meta tensors, the kernels the DiT's joint attention asks for: the
    fused QK-LN flat form (B1) only at head dims 32, 64 and 128 (JAX's
    `layers.py:276-278`) where the heads pack into 128 lanes (elsewhere
    JAX's flat kernel asserts; the port takes the unfused path, the same
    function); otherwise the QK norms (B10), then B7's flat kernels where
    `heads % max(1, 128 // D) == 0` (JAX's rule: 6 x 48 passes it and then
    meets the flat kernels' own check, as in JAX), else B11 / B12 + B13 on
    the bshd view."""
    asked = []

    def record(name):
        def fn(x, *args, **kw):
            asked.append(name)
            return x
        return fn

    monkeypatch.setattr(tlayers, "flash_attention", record("B1"))
    monkeypatch.setattr(tlayers, "flash_attention_flat", record("flat"))
    monkeypatch.setattr(tlayers, "attention", record("bshd"))
    monkeypatch.setattr(tlayers, "head_layernorm", record("B10"))
    attn = tlayers.JointSelfAttention(heads * d, heads, d, fuse_qk_norm=fuse,
                                      compute_dtype=torch.bfloat16).to("meta")
    x = torch.empty((1, 1100, heads * d), device="meta")
    enc = torch.empty((1, 24, heads * d), device="meta")
    attn(x, enc, None)
    assert " ".join(dict.fromkeys(asked)) == want


def test_kernel_head_dim_refusals_name_their_roadmap_entries():
    """D % 8 != 0 and D > 256 raise in every flash kernel's check, each
    naming its ROADMAP entry, also where JAX's flat kernels pack the heads
    (32 x 4, 1 x 512); B10 raises at dh % 8 != 0."""
    for d in (8, 16, 24, 40, 256):
        tfa.check_head_dim(d, "bhsd")
    with pytest.raises(ValueError, match="D % 8 == 0.*queue B item 3"):
        tfa.check_flat_head_dim(128, 32)
    with pytest.raises(ValueError, match="D <= 256.*queue B item 4"):
        tfa.check_flat_head_dim(512, 1)
    meta = torch.empty((1, 4, 1024, 20), device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="queue B item 3"):
        tfa.flash_attention_fwd(meta, meta, meta)
    meta = torch.empty((1, 2, 1024, 320), device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="queue B item 4"):
        tfa.flash_attention_fwd(meta, meta, meta)
    x = torch.empty((4, 120), device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="queue B item 3"):
        tln.head_layernorm(x, torch.ones(12, device="meta"), torch.zeros(12, device="meta"))


def test_stab_attention_at_dh_256_matches_jax():
    """The STAB spatial attention with one head of 256 at S = 1,056 (the
    flat kernels' path, B7's plain version here) against JAX's, which takes
    its flash kernel at `dh % 64 == 0`; 1e-5 of the output's magnitude."""
    dim, heads, s = 256, 1, 1056
    x = np.random.default_rng(33).standard_normal((2, s, dim)).astype(np.float32)
    jm = jrouter.SelfAttention(dim, heads, dtype=jnp.float32)
    params = realistic(jax.eval_shape(jm.init, jax.random.key(33), jnp.asarray(x))["params"],
                       seed=33)
    want = jm.apply({"params": params}, jnp.asarray(x))
    tm = trouter.SelfAttention(dim, heads, compute_dtype=torch.float32, dtype=torch.float32)
    tm.load_state_dict(jax_params_to_torch(params), strict=True)
    with torch.no_grad():
        got = tm(*to_torch(x))
    assert _rel(got, want) < 1e-5

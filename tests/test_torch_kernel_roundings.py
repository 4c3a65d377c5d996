"""The order of operations of the streamed B5 / B5' forward and of the
short-KV general body, emulated in plain PyTorch on the CPU and held
against the plain versions and against JAX, at phase 2's tolerances
(1e-2 + 2e-2 |ref|, `chip_smoke.py`).

A CPU tensor takes each kernel's plain version, so the card's kernels do not
run here; these emulations repeat their roundings, in their order:
  * B5 past each long body's cap (`csrc/packed_attention_stream.cu`): one
    pass over 64-key blocks with an online softmax in fp32; P is rounded to
    bf16 before it is divided by its row's sum (the sum divides O in fp32 at
    the end), where the plain version and JAX normalise P first.  At S = 201
    and 400 (801 and 1,597 frames) over M = 2 rows of 8 heads of 64, bf16
    inputs drawn with numpy, against `tiny_seq_attention_plain` and against
    JAX's `tiny_seq_attention` on the CPU (its einsum spec, `_spec_channel`).
  * B3 on the general body (`csrc/short_kv_attention.cu`): per identity, its
    softmax normalised in fp32, P rounded to bf16, P V in fp32, then the
    sum weighted by w in fp32 (the TPU body's order; the fold of w into P
    before the rounding measured past phase 2's tolerance on the card), at
    the token and identity counts of phase 3i's DiTs, (K, I) = (24, 3) and
    (64, 5), and (8, 3): against `short_kv_attention_combined_flat_plain` on
    bf16 inputs and against the TPU body `_kernel_flat` run in interpret
    mode on fp32 inputs, from `test_torch_short_kv_tokens._jax_bodies` (the
    same calls that file makes, cached per process).
  * B8 past each long body's cap (`csrc/packed_attention_stream.cu`, two
    wgmma kernels): each row's max, sum and delta = sum_b p dp in one
    online pass over key blocks of 64 (32 at dh 256) in fp32, then P =
    2^(s sl - m sl) / sum and dS = P (dP - delta) * scale in fp32, each
    rounded to bf16 as the operand of its product (dV = P^T G, dQ = dS K,
    dK = dS^T Q, fp32 sums, one bf16 store).  At S = 201 over 8 heads of 64
    and at S = 49 over 2 heads of 256 (M = 8), bf16 inputs drawn with
    numpy, against `tiny_seq_attention_bwd_plain` and against JAX's
    `_slice_bwd_kernel` through `_tiny_bwd_pallas(interpret=True)` on the
    same values in fp32, at phase 2's B8 tolerance (1e-2 of each
    gradient's largest magnitude).
  * The flash forward's 256-column body (`csrc/flash_attention.cu:
    fwd_body256`, B1 and B7's forward at 128 < D <= 256): an online
    softmax over 64-key blocks (128 on the narrower bodies) with the
    scale in the exponent, P rounded to bf16 unnormalised, O rescaled as
    the max grows and divided by the sum in fp32 at the end, and the LSE.
    At 2 heads of 256, S = 300 with kv_len = 270, against
    `flash_attention_flat_fwd_plain` and against JAX's `_fwd_flat_impl`
    (B7's forward, with its LSE) and `_fwd_flat_t_impl` (B1) in interpret
    mode, at phase 2's tolerances (1e-2 + 2e-2 |ref|; the LSE 3e-3).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bindyouravatar_tpu.ops import flash_attention as jfa
from bindyouravatar_tpu.ops import packed_attention as jpa
from bindyouravatar_tpu_torch.ops import flash_attention as tfa
from bindyouravatar_tpu_torch.ops import packed_attention as tpa
from bindyouravatar_tpu_torch.ops import short_kv_attention as tskv
from test_torch_short_kv_tokens import D, G, H, SCALE, SQ, _jax_bodies
from torch_port_utils import threads_per_worker

ATOL, RTOL = 1e-2, 2e-2  # phase 2's tolerances for the streamed B5 and the token rows
BF = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def _threads():
    with threads_per_worker():
        yield


def _within(got: torch.Tensor, want: torch.Tensor) -> None:
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    excess = float((diff - (ATOL + RTOL * want.abs())).max())
    assert excess <= 0.0, f"max |d| {float(diff.max()):.3e} passes the tolerance by {excess:.3e}"


def b5_one_pass(q, k, v, heads: int, scale: float, block: int = 64) -> torch.Tensor:
    """The streamed B5 forward's order on [M, S, H*dh] bf16 q, k, v: per
    (row, head), key blocks of `block` in order, fp32 scores, the running
    max and sum in fp32 (log2 units, the sum rescaled as the max grows), P
    rounded to bf16 unnormalised and multiplied by V in fp32, O rescaled as
    the max grows and divided by the sum in fp32 at the end, one bf16
    store.  The last block holds only the keys < S (the kernel masks the
    columns past S)."""
    m, s, c = q.shape
    dh = c // heads
    qs, ks, vs = (t.reshape(m, s, heads, dh).transpose(1, 2).float() for t in (q, k, v))
    sl = scale * math.log2(math.e)
    mx = torch.full((m, heads, s, 1), -1e30)
    l = torch.zeros((m, heads, s, 1))
    o = torch.zeros((m, heads, s, dh))
    for j in range(0, s, block):
        sc = qs @ ks[:, :, j:j + block].transpose(-1, -2)
        new = torch.maximum(mx, sc.amax(-1, keepdim=True))
        alpha = torch.exp2((mx - new) * sl)
        p = torch.exp2(sc * sl - new * sl)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + p.to(BF).float() @ vs[:, :, j:j + block]
        mx = new
    return (o / l).to(BF).transpose(1, 2).reshape(m, s, c)


def b3_general(q, k, v, w, scale: float) -> torch.Tensor:
    """The short-KV general body's combined order on flat q [G, Sq, H*D],
    k, v [G, I, H, K, D] (K <= 64: one key block an identity), w [G, Sq,
    I]: per identity fp32 scores, its softmax in log2 units normalised in
    fp32, P rounded to bf16, P V in fp32, then the sum weighted by w in fp32
    in identity order, one bf16 store.  q keeps its dtype's values (bf16
    inputs, or fp32 ones against the fp32 TPU body)."""
    g, sq, hd = q.shape
    n_id, h, d = k.shape[1], k.shape[2], k.shape[4]
    qh = q.reshape(g, sq, h, d).transpose(1, 2).float()               # [G, H, Sq, D]
    sl = scale * math.log2(math.e)
    acc = torch.zeros((g, h, sq, d))
    for i in range(n_id):
        sc = qh @ k[:, i].float().transpose(-1, -2)                    # [G, H, Sq, K]
        p = torch.exp2(sc * sl - sc.amax(-1, keepdim=True) * sl)
        p = (p / p.sum(-1, keepdim=True)).to(BF).float()
        acc = acc + w[:, :, i].float()[:, None, :, None] * (p @ v[:, i].float())
    return acc.to(q.dtype).transpose(1, 2).reshape(g, sq, hd)


def _b5_inputs(s: int):
    m, heads, dh = 2, 8, 64
    rng = np.random.default_rng(2300 + s)
    q, k, v = (torch.from_numpy(rng.standard_normal((m, s, heads * dh)).astype(np.float32)).to(BF)
               for _ in range(3))
    return q, k, v, heads, dh ** -0.5


@pytest.mark.parametrize("s", [201, 400])
def test_b5_one_pass_order_against_the_plain_version(s):
    """The one-pass order against B5's plain version (P normalised in fp32,
    then rounded) on the same bf16 inputs."""
    q, k, v, heads, scale = _b5_inputs(s)
    _within(b5_one_pass(q, k, v, heads, scale),
            tpa.tiny_seq_attention_plain(q, k, v, heads, scale))


@pytest.mark.parametrize("s", [201, 400])
def test_b5_one_pass_order_against_jax(s):
    """The one-pass order against JAX's `tiny_seq_attention` on the CPU on
    the same bf16 inputs."""
    q, k, v, heads, scale = _b5_inputs(s)
    as_jax = lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    want = jpa.tiny_seq_attention(as_jax(q), as_jax(k), as_jax(v), heads, scale)
    _within(b5_one_pass(q, k, v, heads, scale),
            torch.from_numpy(np.array(want.astype(jnp.float32))))


# (K, I): phase 3i's face tokens at 3 identities and audio tokens at 5, and a
# 16-key block at 3 (cases of `_jax_bodies`'s grid)
B3_CASES = [(24, 3), (64, 5), (8, 3)]


@pytest.mark.parametrize("kk,n_id", B3_CASES)
def test_b3_general_order_against_the_plain_version(kk, n_id):
    """The general body's combined order against B3's plain version (each
    identity's output rounded to bf16 before the weighted sum) on the same
    bf16 inputs: `_jax_bodies`'s draws, rounded."""
    inputs, _ = _jax_bodies(kk, n_id)
    q, k, v, w = (torch.from_numpy(inputs[n]).to(BF) for n in ("q_f", "k", "v", "w"))
    _within(b3_general(q, k, v, w, SCALE),
            tskv.short_kv_attention_combined_flat_plain(q, k, v, w, SCALE))


@pytest.mark.parametrize("kk,n_id", B3_CASES)
def test_b3_general_order_against_the_tpu_body(kk, n_id):
    """The general body's combined order on fp32 inputs against the TPU body
    `_kernel_flat` (interpret mode, fp32): the bf16 rounding of P is the
    difference."""
    inputs, out = _jax_bodies(kk, n_id)
    q, k, v, w = (torch.from_numpy(inputs[n]) for n in ("q_f", "k", "v", "w"))
    got = b3_general(q, k, v, w, SCALE)
    assert got.shape == (G, SQ, H * D)
    _within(got, torch.from_numpy(out["_kernel_flat", True]))


# ------------------------------------------------------- B8 past the cap
B8_TOL = 1e-2  # phase 2's: of each gradient's largest magnitude


def _within_max(got: torch.Tensor, want: torch.Tensor) -> None:
    got, want = got.float(), want.float()
    err, top = float((got - want).abs().max()), float(want.abs().max())
    assert err <= B8_TOL * top, f"max |d| {err:.3e} past {B8_TOL} x {top:.3e}"


def b8_two_pass(q, k, v, g, heads: int, scale: float, block: int):
    """The streamed B8's order on [M, S, H*dh] bf16 q, k, v and output
    gradient g: per (row, head) fp32 scores S = q k^T and dP = g v^T; each
    row's max, sum and sum_b p dp in one pass over key blocks of `block`
    (the sum and delta rescaled as the max grows, in log2 units); then P =
    2^(s sl - m sl) / sum and dS = P (dP - delta) * scale in fp32, each
    rounded to bf16 before its product, the products summed in fp32, one
    bf16 store of dq, dk, dv."""
    m, s, c = q.shape
    dh = c // heads
    qs, ks, vs, gs = (t.reshape(m, s, heads, dh).transpose(1, 2).float() for t in (q, k, v, g))
    sl = scale * math.log2(math.e)
    sc, dp = qs @ ks.transpose(-1, -2), gs @ vs.transpose(-1, -2)
    mx = torch.full((m, heads, s, 1), -1e30)
    l, dl = torch.zeros((m, heads, s, 1)), torch.zeros((m, heads, s, 1))
    for j in range(0, s, block):
        new = torch.maximum(mx, sc[..., j:j + block].amax(-1, keepdim=True))
        p = torch.exp2(sc[..., j:j + block] * sl - new * sl)
        alpha = torch.exp2((mx - new) * sl)
        l = l * alpha + p.sum(-1, keepdim=True)
        dl = dl * alpha + (p * dp[..., j:j + block]).sum(-1, keepdim=True)
        mx = new
    p = torch.exp2(sc * sl - mx * sl) / l
    ds = p * (dp - dl / l) * scale
    p16, ds16 = p.to(BF).float(), ds.to(BF).float()
    out = (ds16 @ ks, ds16.transpose(-1, -2) @ qs, p16.transpose(-1, -2) @ gs)
    return tuple(t.to(BF).transpose(1, 2).reshape(m, s, c) for t in out)


# (S, heads, dh): 801 frames at the 5B STAB heads; one past the 256 body's cap
B8_CASES = [(201, 8, 64), (49, 2, 256)]


def _b8_inputs(s: int, heads: int, dh: int):
    rng = np.random.default_rng(2400 + s)
    return tuple(torch.from_numpy(rng.standard_normal((8, s, heads * dh)).astype(np.float32))
                 .to(BF) for _ in range(4))


@pytest.mark.parametrize("s,heads,dh", B8_CASES)
def test_b8_two_pass_order_against_the_plain_version(s, heads, dh):
    """The streamed B8's order against B8's plain version (fp32 throughout)
    on the same bf16 inputs."""
    q, k, v, g = _b8_inputs(s, heads, dh)
    got = b8_two_pass(q, k, v, g, heads, dh ** -0.5, 32 if dh > 128 else 64)
    for a, b in zip(got, tpa.tiny_seq_attention_bwd_plain(q, k, v, g, heads, dh ** -0.5)):
        _within_max(a, b)


@pytest.mark.parametrize("s,heads,dh", B8_CASES)
def test_b8_two_pass_order_against_the_tpu_kernel(s, heads, dh):
    """The streamed B8's order against JAX's `_slice_bwd_kernel` in
    interpret mode on the same values in fp32."""
    q, k, v, g = _b8_inputs(s, heads, dh)
    want = jpa._tiny_bwd_pallas(*(jnp.asarray(t.float().numpy()) for t in (q, k, v, g)), heads,
                                dh ** -0.5, interpret=True)
    got = b8_two_pass(q, k, v, g, heads, dh ** -0.5, 32 if dh > 128 else 64)
    for a, b in zip(got, want):
        _within_max(a, torch.from_numpy(np.asarray(b)))


# ------------------------------------------- the 256-column flash forward
FWD_S, FWD_KV, FWD_H, FWD_D = 300, 270, 2, 256


def flash_fwd_blocks(q, k, v, heads: int, scale: float, kv_len: int, block: int = 64):
    """The flash forward's order on flat [B, S, H*D] bf16 q, k, v without
    LN or RoPE (the bare calls: the scale in the exponent): key blocks of
    `block` in order, columns >= kv_len masked, fp32 scores, the running
    max and sum in log2 units, P rounded to bf16 unnormalised and
    multiplied by V in fp32, O rescaled as the max grows and divided by the
    sum at the end, one bf16 store; the LSE m scale + ln(sum)."""
    b, s, c = q.shape
    d = c // heads
    qs, ks, vs = (t.reshape(b, s, heads, d).transpose(1, 2).float() for t in (q, k, v))
    sl = scale * math.log2(math.e)
    mx = torch.full((b, heads, s, 1), -1e30)
    l, o = torch.zeros((b, heads, s, 1)), torch.zeros((b, heads, s, d))
    for j in range(0, kv_len, block):
        sc = qs @ ks[:, :, j:min(j + block, kv_len)].transpose(-1, -2)
        new = torch.maximum(mx, sc.amax(-1, keepdim=True))
        alpha = torch.exp2((mx - new) * sl)
        p = torch.exp2(sc * sl - new * sl)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + p.to(BF).float() @ vs[:, :, j:min(j + block, kv_len)]
        mx = new
    lse = (mx * scale + torch.log(l))[..., 0]
    return (o / l).to(BF).transpose(1, 2).reshape(b, s, c), lse


def _fwd_inputs():
    rng = np.random.default_rng(2401)
    return tuple(torch.from_numpy(rng.standard_normal((1, FWD_S, FWD_H * FWD_D))
                                  .astype(np.float32)).to(BF) for _ in range(3))


def test_flash_fwd_256_order_against_the_plain_version():
    """The 256-column body's order against B7's plain forward (output and
    LSE) on the same bf16 inputs."""
    q, k, v = _fwd_inputs()
    o, lse = flash_fwd_blocks(q, k, v, FWD_H, FWD_D ** -0.5, FWD_KV)
    o_want, lse_want = tfa.flash_attention_flat_fwd_plain(q, k, v, FWD_H, kv_len=FWD_KV)
    _within(o, o_want)
    assert float((lse - lse_want).abs().max()) <= 3e-3


def test_flash_fwd_256_order_against_the_tpu_kernels():
    """The 256-column body's order against JAX's flat kernels in interpret
    mode on the same values in fp32: `_fwd_flat_impl` (B7's forward, its
    output and LSE) and `_fwd_flat_t_impl` (B1, V given transposed; its
    rows past kv_len are not the attention's, so the rows below it, as
    `test_torch_head_dims_general` compares them)."""
    q, k, v = _fwd_inputs()
    qj, kj, vj = (jnp.asarray(t.float().numpy()) for t in (q, k, v))
    o_b7, lse_b7 = jfa._fwd_flat_impl(qj, kj, vj, FWD_H, None, FWD_D ** -0.5, FWD_KV, 128, 128,
                                      True, save_residuals=True)
    o_b1 = jfa._fwd_flat_t_impl(qj, kj, jnp.swapaxes(vj, 1, 2), FWD_H, None, FWD_D ** -0.5,
                                FWD_KV, 128, 128, True)
    o, lse = flash_fwd_blocks(q, k, v, FWD_H, FWD_D ** -0.5, FWD_KV)
    _within(o, torch.from_numpy(np.asarray(o_b7)))
    _within(o[:, :FWD_KV], torch.from_numpy(np.asarray(o_b1))[:, :FWD_KV])
    lse_want = torch.from_numpy(np.asarray(lse_b7)).reshape(1, FWD_H, FWD_S)
    assert float((lse - lse_want).abs().max()) <= 3e-3

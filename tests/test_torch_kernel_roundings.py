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
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bindyouravatar_tpu.ops import packed_attention as jpa
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

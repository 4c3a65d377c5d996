"""Triton source of kernel B4 (pair-axis multi-ID attention).

Replaces the TPU kernel `_pair_kernel` (bindyouravatar_tpu/ops/
packed_attention.py), reached through `pair_axis_attention` from the
router's multi-ID STAB attention (q/k/v [B, 2, M, C] with the identity
axis leading, M = T*H*W = 17,550 and C = 8 heads x 64 at the 5B path; 4 x
128 or 16 x 32 at other `attn_heads`).

Written in Triton: per (b, m, head) the work is four dh-wide dot products,
one sigmoid and one lerp; there is no matrix product, so it is a fused
elementwise pass with a segmented reduction, which Triton serves as well as
CUDA would.

What bounds it on the H100: memory.  It reads q, k, v once and writes the
output once (4 x 72 MB at the 5B path, ~0.086 ms at 3.35 TB/s) for ~10
FLOP per element.  Design: one program holds BLOCK_M rows of HB heads of
all six operands in registers as [rows, HB, DP] tiles, takes the per-head
dots as a sum over the last axis (fp32, q scaled first as on the TPU),
forms the closed-form 2-way softmax weight sigmoid(s_i1 - s_i0) per head,
and writes both identities' rows.  Any C and head count: Triton's blocks
are powers of two, so the head width is padded to DP and the heads to HB
(`packed_attention.pair_blocks`), the padded lanes masked on load (read as
0, so they add nothing to a head's dot) and on store, as are rows past M
and heads past the last; a grid column per HB heads keeps a program's
tiles near 4,096 elements whatever C is.

Imported only by `packed_attention.pair_axis_attention` when it launches on
a CUDA tensor: this module imports `triton`, which only the GPU machine has.
"""

import triton
import triton.language as tl


@triton.jit
def pair_attention_kernel(q_ptr, k_ptr, v_ptr, o_ptr, M, sm_scale, C: tl.constexpr,
                          HEADS: tl.constexpr, DH: tl.constexpr, DP: tl.constexpr,
                          HB: tl.constexpr, BLOCK_M: tl.constexpr):
    pid = tl.program_id(0)
    h0 = tl.program_id(1) * HB
    b = tl.program_id(2).to(tl.int64)
    rows = pid * BLOCK_M + tl.arange(0, BLOCK_M)
    heads = h0 + tl.arange(0, HB)
    cols = tl.arange(0, DP)
    # the pad lanes' masks only where there is a pad (a row mask alone keeps
    # the loads 16 bytes wide); tl.load and tl.store broadcast it
    mask = rows[:, None, None] < M
    if HEADS % HB != 0:
        mask = mask & (heads[None, :, None] < HEADS)
    if DP != DH:
        mask = mask & (cols[None, None, :] < DH)
    offs = (rows[:, None, None].to(tl.int64) * C + heads[None, :, None] * DH
            + cols[None, None, :])
    base0 = (2 * b) * M * C
    base1 = base0 + M * C
    q0 = tl.load(q_ptr + base0 + offs, mask=mask, other=0.0).to(tl.float32) * sm_scale
    q1 = tl.load(q_ptr + base1 + offs, mask=mask, other=0.0).to(tl.float32) * sm_scale
    k0 = tl.load(k_ptr + base0 + offs, mask=mask, other=0.0).to(tl.float32)
    k1 = tl.load(k_ptr + base1 + offs, mask=mask, other=0.0).to(tl.float32)
    s00 = tl.sum(q0 * k0, axis=2)
    s01 = tl.sum(q0 * k1, axis=2)
    s10 = tl.sum(q1 * k0, axis=2)
    s11 = tl.sum(q1 * k1, axis=2)
    w0 = 1.0 / (1.0 + tl.exp(s00 - s01))           # sigmoid(s01 - s00)
    w1 = 1.0 / (1.0 + tl.exp(s10 - s11))
    v0 = tl.load(v_ptr + base0 + offs, mask=mask, other=0.0).to(tl.float32)
    v1 = tl.load(v_ptr + base1 + offs, mask=mask, other=0.0).to(tl.float32)
    dv = v1 - v0
    o0 = (v0 + w0[:, :, None] * dv).to(o_ptr.dtype.element_ty)
    o1 = (v0 + w1[:, :, None] * dv).to(o_ptr.dtype.element_ty)
    tl.store(o_ptr + base0 + offs, o0, mask=mask)
    tl.store(o_ptr + base1 + offs, o1, mask=mask)

"""Triton sources of kernel B10, the per-head LayerNorm forward and
backward.  B6 and B9, the row LayerNorm forward and backward, are CUDA C++
(`csrc/layernorm.cu`).

Both take a flat row of C = H * SEG columns as a two-dimensional [HB, SB]
block, HB and SB the powers of two at or above the head count H and the
head width SEG (Triton's blocks are powers of two): element (h, c) is
column h * SEG + c, masked where h >= H or c >= SEG.  Statistics are per
block row over the SEG real columns, divided by SEG, never by the padded
SB; the affine is shared across heads (element (h, c) takes w[c]).  Any
SEG works so (24, 40, 48, 80, 96, ...), at any head count: the padding
costs registers and instruction slots, not memory traffic, since masked lanes
load nothing.

Why Triton serves this as well as CUDA C++ would: the op is bound by
memory (4-6 bytes an element against ~10 FLOP), one program keeps a whole
row in registers, and the two reductions per head are along the block's
minor axis, which Triton lowers to the same warp shuffles a hand-written
kernel would use; the loads and stores are contiguous runs of the row.

Imported only by `layernorm.py` when it launches on a CUDA tensor: this
module imports `triton`, which only the GPU machine has.
"""

import triton
import triton.language as tl


@triton.jit
def ln_fwd_kernel(x_ptr, w_ptr, b_ptr, y_ptr, n_heads, eps, SEG: tl.constexpr,
                  HB: tl.constexpr, SB: tl.constexpr):
    """One program per row: bf16 row in registers as [HB, SB], fp32 mean
    and centred variance per head over its SEG columns, affine in fp32,
    one bf16 write."""
    row = tl.program_id(0).to(tl.int64)
    hs = tl.arange(0, HB)[:, None]
    cs = tl.arange(0, SB)[None, :]
    mask = (hs < n_heads) & (cs < SEG)
    off = row * n_heads * SEG + hs * SEG + cs
    x = tl.load(x_ptr + off, mask=mask, other=0.0).to(tl.float32)
    mean = tl.sum(x, axis=1) / SEG
    xc = tl.where(mask, x - mean[:, None], 0.0)
    rstd = tl.rsqrt(tl.sum(xc * xc, axis=1) / SEG + eps)
    w = tl.load(w_ptr + cs, mask=cs < SEG, other=0.0)
    b = tl.load(b_ptr + cs, mask=cs < SEG, other=0.0)
    y = xc * rstd[:, None] * w + b
    tl.store(y_ptr + off, y.to(y_ptr.dtype.element_ty), mask=mask)


@triton.jit
def ln_bwd_kernel(x_ptr, w_ptr, g_ptr, dx_ptr, dw_ptr, db_ptr, n_rows, n_heads, rows_per_prog,
                  eps, SEG: tl.constexpr, HB: tl.constexpr, SB: tl.constexpr):
    """Rows [pid * rows_per_prog, +rows_per_prog) of one program, one at a
    time: statistics recomputed per head as in the forward, then
        xhat = (x - mu) r,  gy = g w
        dx = r (gy - mean(gy) - xhat mean(gy xhat))   (means per head)
    stored in x's dtype, and the program's partial sums of g * xhat and g
    over its rows kept in fp32 registers and written as row `pid` of the
    [programs, C] partials (a second pass sums them over programs and
    heads).  Rows past n_rows load as zeros and add nothing."""
    pid = tl.program_id(0)
    hs = tl.arange(0, HB)[:, None]
    cs = tl.arange(0, SB)[None, :]
    hmask = (hs < n_heads) & (cs < SEG)
    cols = hs * SEG + cs
    n_cols = n_heads * SEG
    w = tl.load(w_ptr + cs, mask=cs < SEG, other=0.0)
    dw_acc = tl.zeros((HB, SB), dtype=tl.float32)
    db_acc = tl.zeros((HB, SB), dtype=tl.float32)
    row0 = pid.to(tl.int64) * rows_per_prog
    for i in range(rows_per_prog):
        row = row0 + i
        mask = hmask & (row < n_rows)
        off = row * n_cols + cols
        x = tl.load(x_ptr + off, mask=mask, other=0.0).to(tl.float32)
        g = tl.load(g_ptr + off, mask=mask, other=0.0).to(tl.float32)
        mean = tl.sum(x, axis=1) / SEG
        xc = tl.where(mask, x - mean[:, None], 0.0)
        r = tl.rsqrt(tl.sum(xc * xc, axis=1) / SEG + eps)
        xhat = xc * r[:, None]
        gy = g * w
        mg = tl.sum(gy, axis=1) / SEG
        mgx = tl.sum(gy * xhat, axis=1) / SEG
        dx = r[:, None] * (gy - mg[:, None] - xhat * mgx[:, None])
        tl.store(dx_ptr + off, dx.to(dx_ptr.dtype.element_ty), mask=mask)
        dw_acc += g * xhat
        db_acc += g
    poff = pid.to(tl.int64) * n_cols + cols
    tl.store(dw_ptr + poff, dw_acc, mask=hmask)
    tl.store(db_ptr + poff, db_acc, mask=hmask)

"""Triton sources of kernel B10, the per-head LayerNorm forward and
backward.  B6 and B9, the row LayerNorm forward and backward, are CUDA C++
(`csrc/layernorm.cu`).

Both compute statistics over SEG-wide segments of a flat row with the
affine shared across segments (B10: heads of 32, 64 or 128).

Imported only by `layernorm.py` when it launches on a CUDA tensor: this
module imports `triton`, which only the GPU machine has.
"""

import triton
import triton.language as tl


@triton.jit
def ln_fwd_kernel(x_ptr, w_ptr, b_ptr, y_ptr, n_cols, eps, BLOCK: tl.constexpr,
                  SEG: tl.constexpr):
    """One program per row: bf16 row in registers, fp32 mean and centred
    variance over each row of its [BLOCK // SEG, SEG] view (whole SEG-wide
    segments: n_cols is a multiple of SEG), affine in fp32 (element c takes
    w[c % SEG]), one bf16 write."""
    row = tl.program_id(0).to(tl.int64)
    cols = tl.arange(0, BLOCK)
    mask = cols < n_cols
    x = tl.load(x_ptr + row * n_cols + cols, mask=mask, other=0.0).to(tl.float32)
    xs = tl.reshape(x, (BLOCK // SEG, SEG))
    ms = tl.reshape(mask, (BLOCK // SEG, SEG))
    mean = tl.sum(xs, axis=1) / SEG
    xc = tl.where(ms, xs - mean[:, None], 0.0)
    rstd = tl.rsqrt(tl.sum(xc * xc, axis=1) / SEG + eps)
    y = tl.reshape(xc * rstd[:, None], (BLOCK,))
    w = tl.load(w_ptr + cols % SEG, mask=mask, other=0.0)
    b = tl.load(b_ptr + cols % SEG, mask=mask, other=0.0)
    tl.store(y_ptr + row * n_cols + cols, (y * w + b).to(y_ptr.dtype.element_ty), mask=mask)


@triton.jit
def ln_bwd_kernel(x_ptr, w_ptr, g_ptr, dx_ptr, dw_ptr, db_ptr, n_rows, n_cols, rows_per_prog,
                  eps, BLOCK: tl.constexpr, SEG: tl.constexpr):
    """Rows [pid * rows_per_prog, +rows_per_prog) of one program, one at a
    time: statistics recomputed per segment as in the forward, then
        xhat = (x - mu) r,  gy = g w
        dx = r (gy - mean(gy) - xhat mean(gy xhat))   (means per segment)
    stored in x's dtype, and the program's partial sums of g * xhat and g
    over its rows kept in fp32 registers and written as row `pid` of the
    [programs, n_cols] partials (a second pass sums them).  Rows past
    n_rows load as zeros and add nothing."""
    pid = tl.program_id(0)
    cols = tl.arange(0, BLOCK)
    cmask = cols < n_cols
    ms = tl.reshape(cmask, (BLOCK // SEG, SEG))
    w = tl.reshape(tl.load(w_ptr + cols % SEG, mask=cmask, other=0.0), (BLOCK // SEG, SEG))
    dw_acc = tl.zeros((BLOCK // SEG, SEG), dtype=tl.float32)
    db_acc = tl.zeros((BLOCK // SEG, SEG), dtype=tl.float32)
    row0 = pid.to(tl.int64) * rows_per_prog
    for i in range(rows_per_prog):
        row = row0 + i
        mask = cmask & (row < n_rows)
        off = row * n_cols + cols
        x = tl.reshape(tl.load(x_ptr + off, mask=mask, other=0.0).to(tl.float32),
                       (BLOCK // SEG, SEG))
        g = tl.reshape(tl.load(g_ptr + off, mask=mask, other=0.0).to(tl.float32),
                       (BLOCK // SEG, SEG))
        mean = tl.sum(x, axis=1) / SEG
        xc = tl.where(ms, x - mean[:, None], 0.0)
        r = tl.rsqrt(tl.sum(xc * xc, axis=1) / SEG + eps)
        xhat = xc * r[:, None]
        gy = g * w
        mg = tl.sum(gy, axis=1) / SEG
        mgx = tl.sum(gy * xhat, axis=1) / SEG
        dx = r[:, None] * (gy - mg[:, None] - xhat * mgx[:, None])
        tl.store(dx_ptr + off, tl.reshape(dx, (BLOCK,)).to(dx_ptr.dtype.element_ty), mask=mask)
        dw_acc += g * xhat
        db_acc += g
    poff = pid.to(tl.int64) * n_cols + cols
    tl.store(dw_ptr + poff, tl.reshape(dw_acc, (BLOCK,)), mask=cmask)
    tl.store(db_ptr + poff, tl.reshape(db_acc, (BLOCK,)), mask=cmask)

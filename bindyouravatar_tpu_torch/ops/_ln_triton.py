"""Triton source of kernel B6 (row LayerNorm forward).

Imported only by `layernorm.fused_layernorm` when it launches on a CUDA
tensor: this module imports `triton`, which only the GPU machine has.
"""

import triton
import triton.language as tl


@triton.jit
def ln_fwd_kernel(x_ptr, w_ptr, b_ptr, y_ptr, n_cols, eps, BLOCK: tl.constexpr):
    """One program per row: bf16 row in registers, fp32 mean and centred
    variance, affine in fp32, one bf16 write."""
    row = tl.program_id(0).to(tl.int64)
    cols = tl.arange(0, BLOCK)
    mask = cols < n_cols
    x = tl.load(x_ptr + row * n_cols + cols, mask=mask, other=0.0).to(tl.float32)
    mean = tl.sum(x, axis=0) / n_cols
    xc = tl.where(mask, x - mean, 0.0)
    var = tl.sum(xc * xc, axis=0) / n_cols
    rstd = tl.rsqrt(var + eps)
    w = tl.load(w_ptr + cols, mask=mask, other=0.0)
    b = tl.load(b_ptr + cols, mask=mask, other=0.0)
    y = xc * rstd * w + b
    tl.store(y_ptr + row * n_cols + cols, y.to(y_ptr.dtype.element_ty), mask=mask)

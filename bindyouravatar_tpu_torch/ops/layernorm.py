"""LayerNorm kernels: B6 (row LayerNorm forward) and B9 (its backward),
CUDA C++, and B10 (per-head LayerNorm forward and backward, Triton), and
their plain versions.

  * `fused_layernorm` (B6 forward, B9 backward) replaces the TPU kernels
    `_ln_kernel` and `_ln_bwd_kernel` (bindyouravatar_tpu/ops/layernorm.py),
    reached from `LayerNorm(fused=True)`: the audio `norm_q` over
    [B*S, 3072] in every audio layer, the perceiver norms, the router norms
    and the trunk/STAB norms, and the `AudioProjModel` norm once per clip.
    Both are `csrc/layernorm.cu` (persistent blocks, rows as 16-byte
    vectors in registers, the affine read once per block; its source note
    says what bounds them and how).
  * `head_layernorm` (B10) replaces `_hln_fwd_kernel` and `_hln_bwd_kernel`:
    LN over the head segments of a flat [.., H*dh] row with the affine
    shared across heads, the training path's QK norms ([17776, 3072] per
    block at the 5B geometry, 48 heads of 64).  Both directions are
    `_ln_triton.py`: any dh with dh % 8 == 0 that divides the row, at any
    head count, as a [heads, dh] block padded to powers of two and masked,
    the segment width a compile-time constant.

What bounds them on the H100: memory.  The forward reads and writes each
bf16 element once (4 B/element) for ~8 FLOP/element; the backward reads x
and g and writes dx (6 B/element) for ~12 FLOP/element: both far below the
card's ~295 FLOP/B ridge.  The kernels keep whole rows in registers, so the
fp32 statistics, xhat and the affine never touch device memory.  B9 adds
each thread's dscale/dbias partial sums across its rows in shared memory,
writes one [2, D] fp32 partial row per block and folds those rows in the
same launch, in a fixed order (cooperative launch, a grid barrier).  B10's
backward writes per-program partial sums (a [programs, D] fp32 buffer,
~2 MB) that torch sums fold, as the JAX package sums its partials in XLA.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import check, cuda_lib, import_triton

# widths the kernels take: whole rows in registers, 128-element multiples
_MAX_D = 8192
_BWD_PROGRAMS = 528     # B10 backward programs: 4 per SM of the H100
# (device, stream) -> B9's grid-barrier counter: zeroed once, then kept by
# the kernel (each barrier leaves it as it found it); one per stream, since
# launches that share a counter must not run at the same time
_BARRIERS: dict = {}


def layernorm_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dim with fp32 statistics and affine,
    returning x.dtype (the JAX `_ln_ref`)."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def layernorm_bwd_plain(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                        eps: float = 1e-5):
    """Closed-form LayerNorm backward (the JAX `_ln_closed_bwd`) over the
    last dim: (dx in x.dtype, dscale, dbias fp32, summed over all rows)."""
    x32, g32 = x.float(), g.float()
    mu = x32.mean(-1, keepdim=True)
    r = torch.rsqrt((x32 - mu).square().mean(-1, keepdim=True) + eps)
    xhat = (x32 - mu) * r
    gy = g32 * scale.float()
    mg = gy.mean(-1, keepdim=True)
    mgx = (gy * xhat).mean(-1, keepdim=True)
    dx = (r * (gy - mg - xhat * mgx)).to(x.dtype)
    rows = tuple(range(x.ndim - 1))
    return dx, (g32 * xhat).sum(rows), g32.sum(rows)


def head_layernorm_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                         eps: float = 1e-6) -> torch.Tensor:
    """Per-head LayerNorm of a flat [..., H*dh] tensor (dh = scale's size,
    affine shared across heads): the row LayerNorm of the [..., H, dh] view
    (the JAX `_hln_ref`)."""
    dh = scale.shape[0]
    return layernorm_plain(x.reshape(*x.shape[:-1], -1, dh), scale, bias, eps).reshape(x.shape)


def head_layernorm_bwd_plain(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                             eps: float = 1e-6):
    """Backward of `head_layernorm_plain`: the closed form on the [..., H,
    dh] view, dscale/dbias summed over rows and heads."""
    dh = scale.shape[0]
    view = lambda t: t.reshape(*t.shape[:-1], -1, dh)
    dx, ds, db = layernorm_bwd_plain(view(x), scale, view(g), eps)
    return dx.reshape(x.shape), ds, db


def _check(x: torch.Tensor, what: str) -> int:
    d = x.shape[-1]
    if x.device.type != "cuda" or x.dtype != torch.bfloat16 or d % 128 or d > _MAX_D:
        raise ValueError(f"{what} kernel takes bf16 CUDA rows with D % 128 == 0 and "
                         f"D <= {_MAX_D}; got {x.dtype} {tuple(x.shape)} on {x.device}")
    return d


def _row_ln_fwd(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                eps: float) -> torch.Tensor:
    """Kernel B6 over the rows of `x` ([..., D]): the CUDA kernel of
    `csrc/layernorm.cu`, which takes 16-byte-aligned rows and affine (a
    misaligned input is copied first)."""
    d = _check(x, "fused_layernorm (B6)")
    aligned = lambda t: t if t.data_ptr() % 16 == 0 else t.clone()
    x2 = aligned(x.reshape(-1, d).contiguous())
    sc, bi = (aligned(t.float().contiguous()) for t in (scale, bias))
    y = torch.empty_like(x2)
    err = cuda_lib().bya_layernorm_fwd(x2.data_ptr(), sc.data_ptr(), bi.data_ptr(),
                                       y.data_ptr(), x2.shape[0], d, float(eps),
                                       torch.cuda.current_stream(x.device).cuda_stream)
    check(err, "fused_layernorm (B6)")
    return y.view(x.shape)


def _pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def _check_heads(x: torch.Tensor, dh: int, what: str):
    """B10's contract: bf16 CUDA rows of C <= 8192 columns that split into
    heads of dh, dh % 8 == 0 (other head dims: ROADMAP.md queue B item 3).
    Returns (C, heads, the [heads, dh] block's power-of-two sides)."""
    c = x.shape[-1]
    if dh % 8 or c % dh:
        raise ValueError(f"{what} kernel takes heads with dh % 8 == 0 that divide the row; got "
                         f"dh {dh} in {c} columns (other head dims: ROADMAP.md queue B item 3)")
    if x.device.type != "cuda" or x.dtype != torch.bfloat16 or c > _MAX_D:
        raise ValueError(f"{what} kernel takes bf16 CUDA rows with C <= {_MAX_D}; got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")
    heads = c // dh
    return c, heads, _pow2(heads), _pow2(dh)


def _hln_fwd(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
             eps: float) -> torch.Tensor:
    """B10's forward (Triton) over rows of `x` ([..., C]), statistics per
    head segment of scale's width."""
    seg = scale.shape[0]
    d, heads, hb, sb = _check_heads(x, seg, "head_layernorm (B10)")
    import_triton()
    from ._ln_triton import ln_fwd_kernel

    x2 = x.reshape(-1, d).contiguous()
    y = torch.empty_like(x2)
    ln_fwd_kernel[(x2.shape[0],)](
        x2, scale.float().contiguous(), bias.float().contiguous(), y, heads, eps,
        SEG=seg, HB=hb, SB=sb, num_warps=8 if hb * sb >= 4096 else 4)
    return y.view(x.shape)


def _row_ln_bwd(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor, eps: float):
    """Kernel B9 over the rows of `x` ([..., D]): the CUDA kernel of
    `csrc/layernorm.cu` -> (dx in x.dtype, dscale, dbias fp32 [D]).  It
    takes 16-byte-aligned rows and scale (a misaligned input is copied
    first), a [blocks, 2, D] fp32 scratch of partial rows, and the
    stream's grid-barrier counter (`_BARRIERS`)."""
    d = _check(x, "layernorm backward (B9)")
    aligned = lambda t: t if t.data_ptr() % 16 == 0 else t.clone()
    x2 = aligned(x.reshape(-1, d).contiguous())
    g2 = aligned(g.reshape(-1, d).contiguous().to(x.dtype))
    sc = aligned(scale.float().contiguous())
    m, lib = x2.shape[0], cuda_lib()
    if m == 0:
        zero = torch.zeros(d, dtype=torch.float32, device=x.device)
        return torch.empty_like(x), zero, zero.clone()
    stream = torch.cuda.current_stream(x.device)
    blocks = ctypes.c_int(0)
    check(lib.bya_layernorm_bwd_blocks(m, d, ctypes.byref(blocks)), "layernorm backward (B9)")
    bar = _BARRIERS.get((x.device, stream.cuda_stream))
    if bar is None:
        bar = _BARRIERS[(x.device, stream.cuda_stream)] = torch.zeros(
            1, dtype=torch.int32, device=x.device)
    dx = torch.empty_like(x2)
    part = torch.empty((blocks.value, 2, d), dtype=torch.float32, device=x.device)
    dsb = torch.empty((2, d), dtype=torch.float32, device=x.device)
    err = lib.bya_layernorm_bwd(x2.data_ptr(), sc.data_ptr(), g2.data_ptr(), dx.data_ptr(),
                                part.data_ptr(), blocks.value, dsb.data_ptr(), bar.data_ptr(),
                                m, d, float(eps), stream.cuda_stream)
    check(err, "layernorm backward (B9)")
    return dx.view(x.shape), dsb[0], dsb[1]


def _hln_bwd(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor, eps: float):
    """B10's backward kernel (Triton): (dx in x.dtype, per-column
    partial-sum totals of g * xhat and g over the rows, fp32 [C])."""
    seg = scale.shape[0]
    d, heads, hb, sb = _check_heads(x, seg, "head_layernorm backward (B10)")
    import_triton()
    from ._ln_triton import ln_bwd_kernel

    x2, g2 = x.reshape(-1, d).contiguous(), g.reshape(-1, d).contiguous().to(x.dtype)
    m = x2.shape[0]
    rows_per_prog = max(1, -(-m // _BWD_PROGRAMS))
    progs = -(-m // rows_per_prog)
    dx = torch.empty_like(x2)
    dw = torch.empty((progs, d), dtype=torch.float32, device=x.device)
    db = torch.empty_like(dw)
    ln_bwd_kernel[(progs,)](
        x2, scale.float().contiguous(), g2, dx, dw, db, m, heads, rows_per_prog, eps,
        SEG=seg, HB=hb, SB=sb, num_warps=8 if hb * sb >= 2048 else 4)
    return dx.view(x.shape), dw.sum(0), db.sum(0)


class _FusedLayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        y = _row_ln_fwd(x, scale, bias, eps)
        fused_layernorm.launches += 1
        return y

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, ds, db = layernorm_bwd(x, scale, g, ctx.eps)
        return dx, ds.to(scale.dtype), db.to(scale.dtype), None


def fused_layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """Row LayerNorm of `x` ([..., D]).  A CPU tensor takes the plain
    version (autograd differentiates it); a CUDA tensor launches kernel B6
    (bf16, D % 128 == 0, D <= 8192) or raises, and its backward launches
    kernel B9 (the same shapes) or raises."""
    if x.device.type == "cpu":
        return layernorm_plain(x, scale, bias, eps)
    return _FusedLayerNorm.apply(x, scale, bias, eps)


def layernorm_bwd(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor, eps: float = 1e-5):
    """Kernel B9 on its own (what `fused_layernorm`'s backward launches):
    (dx, dscale, dbias) of the row LayerNorm for output gradient `g`.  A
    CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (bf16, D % 128 == 0, D <= 8192) or raises."""
    if x.device.type == "cpu":
        return layernorm_bwd_plain(x, scale, g, eps)
    out = _row_ln_bwd(x, scale, g, eps)
    layernorm_bwd.launches += 1
    return out


class _HeadLayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return head_layernorm_fwd(x, scale, bias, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, ds, db = head_layernorm_bwd(x, scale, g, ctx.eps)
        return dx, ds.to(scale.dtype), db.to(scale.dtype), None


def head_layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """Per-head LayerNorm of a flat [..., H*dh] tensor, dh = scale's size,
    affine shared across heads.  A CPU tensor takes the plain version
    (autograd differentiates it); a CUDA tensor launches kernel B10's
    forward (bf16, dh % 8 == 0 dividing a row of at most 8,192, at any
    head count) or raises, and its backward B10's backward.  (The JAX op
    takes its kernel only for rows of a multiple of 128 holding at most 128
    heads, `_hln_pallas_ok`, and computes the same function in XLA
    otherwise: 15 heads of 64, or 192 heads of 16 at width 3,072.)"""
    if x.device.type == "cpu":
        return head_layernorm_plain(x, scale, bias, eps)
    return _HeadLayerNorm.apply(x, scale, bias, eps)


def head_layernorm_fwd(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                       eps: float = 1e-6) -> torch.Tensor:
    """Kernel B10's forward on its own (CPU tensors: the plain version)."""
    if x.device.type == "cpu":
        return head_layernorm_plain(x, scale, bias, eps)
    y = _hln_fwd(x, scale, bias, eps)
    head_layernorm_fwd.launches += 1
    return y


def head_layernorm_bwd(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                       eps: float = 1e-6):
    """Kernel B10's backward on its own: (dx, dscale, dbias), the partial
    sums folded over rows and then heads (CPU tensors: the plain version)."""
    if x.device.type == "cpu":
        return head_layernorm_bwd_plain(x, scale, g, eps)
    dx, ds, db = _hln_bwd(x, scale, g, eps)
    head_layernorm_bwd.launches += 1
    dh = scale.shape[0]
    return dx, ds.reshape(-1, dh).sum(0), db.reshape(-1, dh).sum(0)


fused_layernorm.launches = 0
layernorm_bwd.launches = 0
head_layernorm_fwd.launches = 0
head_layernorm_bwd.launches = 0


class _LeanLayerNorm(torch.autograd.Function):
    """JAX `ops/layernorm.py:lean_layernorm`: the forward saves the input
    and the squeezed fp32 mean and rsqrt only, the backward is the closed
    form (`layernorm_bwd_plain`'s math from the saved statistics)."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        x32 = x.float()
        mu = x32.mean(-1, keepdim=True)
        xc = x32 - mu
        r = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
        y = (xc * r * scale.float() + bias.float()).to(x.dtype)
        ctx.save_for_backward(x, scale, mu[..., 0], r[..., 0])
        ctx.bias_dtype = bias.dtype
        return y

    @staticmethod
    def backward(ctx, g):
        x, scale, mu, r = ctx.saved_tensors
        mu, r = mu[..., None], r[..., None]
        x32, g32 = x.float(), g.float()
        xhat = (x32 - mu) * r
        gy = g32 * scale.float()
        mg = gy.mean(-1, keepdim=True)
        mgx = (gy * xhat).mean(-1, keepdim=True)
        dx = (r * (gy - mg - xhat * mgx)).to(x.dtype)
        rows = tuple(range(x.ndim - 1))
        return (dx, (g32 * xhat).sum(rows).to(scale.dtype), g32.sum(rows).to(ctx.bias_dtype),
                None)


def lean_layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dim with a memory-lean backward (JAX
    `lean_layernorm`, which JAX's model never selects): what autograd
    keeps is the input plus fp32 [...] mean and rsqrt, not the fp32 chain of
    the plain version.  The same function as `layernorm_plain`; no kernel
    (JAX's is XLA), so the same code on the CPU and the card."""
    return _LeanLayerNorm.apply(x, scale, bias, eps)

"""Attention over tiny sequences for the router's STABs: kernels B4, B5, B5'.

The MultiIPRouter's temporal and multi-ID attentions run over tiny
sequences with huge batches: temporal over S = 13 latent frames for 5,400
rows, multi-ID over the S = 2 identities for 2 x 17,550 rows (dim 512,
8 heads of 64 at the 5B; `RouterConfig.attn_heads` sets other splits, 4
x 128 or 16 x 32).  Each replaces a TPU kernel of
`bindyouravatar_tpu/ops/packed_attention.py`:
  * `tiny_seq_attention` (B5, `_slice_kernel`): channel-packed [M, S, C],
    S >= 8; CUDA C++ (`csrc/packed_attention.cu`).
  * `packed_head_attention` (B5', `_kernel`, the packed-head fold): the
    same function on [M, S*H, D] for S < 8; the B5 kernel instantiated for
    small S (the operand is the same memory as [M, S, H*D]).
  Both take every head width dh % 8 == 0 up to 256 (on a body of 64, 128
  or 256 columns) and every S, as JAX's kernels do: one 16-row tile an
  item up to 16, a whole item in shared memory up to that body's cap in
  `MAX_S` (192, 96, 48), past it a one-pass `wgmma` forward with an item's
  K and V in shared memory (streamed in key blocks past what fits;
  `kernel_body` is the shape rule).
  * `pair_axis_attention` (B4, `_pair_kernel`): attention across a leading
    pair axis [B, 2, M, C] as the closed-form 2-way softmax
    o_i = v0 + sigmoid(s_i1 - s_i0) (v1 - v0); Triton (`_pair_triton.py`),
    any C and heads <= 128 (the JAX kernel's head indicator is 128 wide).
Each has its plain PyTorch version, which a CPU tensor takes; a CUDA tensor
launches the kernel or raises.  The source notes say what bounds them.

Gradients, as the JAX custom vjps decide: `tiny_seq_attention` at S >= 8
runs kernel B8 (`_slice_bwd_kernel`, CUDA C++ on the tensor cores in
`csrc/packed_attention.cu`, standalone as `tiny_seq_attention_bwd`); below
8 it takes the vjp of the plain version, as do `pair_axis_attention` and
`packed_head_attention` (the JAX package has no Pallas backward for them).
"""

from __future__ import annotations

import torch

from ._build import check, cuda_lib, import_triton
from .autograd import kernel_with_plain_vjp
from .flash_attention import body_width

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
# the longest sequence each long body takes (`Geo::LONG_MAX_S` of the
# source): the long bodies hold a (row, head) item whole in shared memory,
# double-buffered, and B8's two buffers of four [S, body + 8] tensors must
# fit a block's 232,448 bytes; past it the streamed body runs
MAX_S = {64: 192, 128: 96, 256: 48}
# the rows of the streamed backward's tiles (`SB_ROWS` of the source): its
# statistics scratch holds whole tiles of rows
STREAM_BWD_ROWS = 64
# the pair kernel's heads: JAX's `_pair_kernel` sums a head's channels with a
# [C, 128] head indicator
PAIR_MAX_HEADS = 128


def body_columns(dh: int, what: str = "tiny_seq_attention (B5 / B5' / B8)") -> int:
    """The columns of the body a dh-wide head rides (64, 128 or 256: the
    narrowest that holds it; the columns past dh are zeros in shared
    memory).  Raises ValueError naming ROADMAP.md queue B item 3 for dh % 8
    != 0 and item 4 for dh > 256 (`body_width`)."""
    return body_width(dh, what)


def kernel_body(s: int, width: int, heads: int, backward: bool = False) -> str:
    """The CUDA body that a call on [M, S, width] with `heads` heads
    launches on the card, from the shape alone: "packed" (B5', S < 8: 16 //
    S items a 16-row tile), "tile" (S <= 16: one item a tile), "long" (16 <
    S <= MAX_S[body_columns(dh)]: a whole item in shared memory, looped
    over 16-row tiles), "stream" (past that cap: the forward a one-pass
    `wgmma` body over 64-row q tiles with an item's K and V in shared
    memory, or streamed in 64-key blocks past what fits; the backward two
    `wgmma` kernels over 64-row tiles, q-major for the rows' statistics
    and dQ, kv-major for dK and dV, the other side's blocks of an item in
    shared memory, streamed past what fits).  The
    backward (B8) takes S >= 8; below, the gradient is the plain version's
    vjp, as in the JAX package.  Raises ValueError, naming the limit and
    its ROADMAP.md queue B item, for a shape no body takes."""
    what = "tiny_seq_attention backward (B8)" if backward else "tiny_seq_attention (B5 / B5')"
    if heads < 1 or width % heads != 0:
        raise ValueError(f"{what}: width {width} does not split into {heads} heads")
    cap = MAX_S[body_columns(width // heads, what)]
    if s < (8 if backward else 1):
        raise ValueError(f"{what}: takes S >= {8 if backward else 1}; got S = {s}")
    return "packed" if s < 8 else "tile" if s <= 16 else "long" if s <= cap else "stream"


def _head_mask(sh: int, heads: int, device: torch.device) -> torch.Tensor:
    """[SH, SH] bool: True where row and column belong to the same head
    (packing (s, h) -> s*H + h, so head id = index mod H)."""
    idx = torch.arange(sh, device=device) % heads
    return idx[:, None] == idx[None, :]


def packed_head_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                heads: int, sm_scale: float) -> torch.Tensor:
    """Plain version of B5' (the JAX `_einsum_attention`: the packed fold
    with the block-diagonal head mask)."""
    sh = q.shape[1]
    s = torch.einsum("mad,mbd->mab", q.float(), k.float()) * sm_scale
    s = s.masked_fill(~_head_mask(sh, heads, q.device), NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("mab,mbd->mad", p.to(v.dtype), v)


def tiny_seq_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             heads: int, sm_scale: float) -> torch.Tensor:
    """Plain version of B5 (the JAX `_spec_channel`)."""
    m, s, c = q.shape
    dh = c // heads
    qs, ks, vs = (t.reshape(m, s, heads, dh) for t in (q, k, v))
    sc = torch.einsum("mahd,mbhd->mhab", qs.float(), ks.float()) * sm_scale
    p = torch.softmax(sc, dim=-1)
    o = torch.einsum("mhab,mbhd->mahd", p.to(vs.dtype), vs)
    return o.reshape(m, s, c)


def tiny_seq_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 g: torch.Tensor, heads: int, sm_scale: float):
    """Plain version of B8 (the JAX `_slice_bwd_kernel`): the fp32 softmax
    vjp per (row, head), scores recomputed -> (dq, dk, dv) in q's dtype."""
    m, s, c = q.shape
    dh = c // heads
    qs, ks, vs, gs = (t.reshape(m, s, heads, dh).float() for t in (q, k, v, g))
    p = torch.softmax(torch.einsum("mahd,mbhd->mhab", qs, ks) * sm_scale, dim=-1)
    dv = torch.einsum("mhab,mahd->mbhd", p, gs)
    dp = torch.einsum("mahd,mbhd->mhab", gs, vs)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True)) * sm_scale
    dq = torch.einsum("mhab,mbhd->mahd", ds, ks)
    dk = torch.einsum("mhab,mahd->mbhd", ds, qs)
    return tuple(t.reshape(m, s, c).to(q.dtype) for t in (dq, dk, dv))


def pair_axis_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              heads: int, sm_scale: float) -> torch.Tensor:
    """Plain version of B4 (the JAX `_pair_spec2`: the closed-form 2-way
    softmax in fp32)."""
    b, s, m, c = q.shape
    dh = c // heads
    q32, k32, v32 = q.float() * sm_scale, k.float(), v.float()
    dots = lambda i, j: (q32[:, i] * k32[:, j]).reshape(b, m, heads, dh).sum(-1)
    w0 = torch.sigmoid(dots(0, 1) - dots(0, 0))            # v1 weight, query 0
    w1 = torch.sigmoid(dots(1, 1) - dots(1, 0))
    v0 = v32[:, 0].reshape(b, m, heads, dh)
    dv = (v32[:, 1] - v32[:, 0]).reshape(b, m, heads, dh)
    o = torch.stack([v0 + w0[..., None] * dv, v0 + w1[..., None] * dv], 1)
    return o.reshape(b, s, m, c).to(q.dtype)


def _launch_tiny(q, k, v, m: int, s: int, heads: int, d: int, sm_scale: float,
                 what: str) -> torch.Tensor:
    """The B5 kernel on [M, S, H*D] memory (shape checks done by the
    caller): past the long body's cap, the streamed forward's entry point
    (`csrc/packed_attention_stream.cu`: one pass, an online softmax on the
    tensor cores, P rounded to bf16 before the division by its row sum)."""
    for t in (q, k, v):
        if not (t.dtype == torch.bfloat16 and t.is_contiguous() and t.data_ptr() % 16 == 0):
            raise ValueError(f"{what} kernel takes contiguous 16-byte aligned bf16 tensors")
    o = torch.empty_like(q)
    lib = cuda_lib()
    stream = kernel_body(s, heads * d, heads) == "stream"
    err = (lib.bya_tiny_seq_attention_stream if stream else lib.bya_tiny_seq_attention)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), m, s, heads, d,
        float(sm_scale), torch.cuda.current_stream(q.device).cuda_stream)
    check(err, what)
    return o


def packed_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          heads: int, sm_scale: float) -> torch.Tensor:
    """Multi-head self-attention over a tiny packed axis: q/k/v [M, S*H, D]
    with packing (s, h) -> s*H + h (the reshape of [M, S, H, D]) -> the
    same.  A CPU tensor takes the plain version; a CUDA tensor launches
    kernel B5' (bf16, D % 8 == 0 up to 256, any S) or raises."""
    if q.device.type == "cpu":
        return packed_head_attention_plain(q, k, v, heads, sm_scale)
    return kernel_with_plain_vjp(_packed_head_kernel, packed_head_attention_plain, (q, k, v),
                                 (heads, sm_scale))


def _packed_head_kernel(q, k, v, heads: int, sm_scale: float) -> torch.Tensor:
    m, sh, d = q.shape
    if not (q.device.type == "cuda" and sh % heads == 0 and k.shape == q.shape
            and v.shape == q.shape):
        raise ValueError(f"packed_head_attention kernel takes CUDA [M, S*H, D]; got "
                         f"{tuple(q.shape)}, {heads} heads on {q.device}")
    kernel_body(sh // heads, heads * d, heads)
    o = _launch_tiny(q, k, v, m, sh // heads, heads, d, sm_scale, "packed_head_attention (B5')")
    packed_head_attention.launches += 1
    return o


packed_head_attention.launches = 0


def tiny_seq_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       heads: int, sm_scale: float) -> torch.Tensor:
    """Multi-head self-attention over a tiny sequence, channel-packed IO:
    q/k/v [M, S, C] (C = heads * dh, h-major) -> [M, S, C].  A CPU tensor
    takes the plain version; on a CUDA tensor S < 8 goes to
    `packed_head_attention` (B5', as the JAX dispatch does) with the plain
    version's vjp as its gradient, S >= 8 launches kernel B5 (bf16, dh % 8
    == 0 up to 256, any S) with kernel B8 as its gradient, and anything
    else raises."""
    if q.device.type == "cpu":
        return tiny_seq_attention_plain(q, k, v, heads, sm_scale)
    m, s, c = q.shape
    if s < 8:
        dh = c // heads
        packed = lambda q_, k_, v_, h_, sc_: _packed_head_kernel(
            *(t.reshape(m, s * h_, dh) for t in (q_, k_, v_)), h_, sc_).reshape(m, s, c)
        return kernel_with_plain_vjp(packed, tiny_seq_attention_plain, (q, k, v),
                                     (heads, sm_scale))
    if not (q.device.type == "cuda" and k.shape == q.shape and v.shape == q.shape):
        raise ValueError(f"tiny_seq_attention kernel takes CUDA [M, S, H*dh]; got "
                         f"{tuple(q.shape)}, {heads} heads on {q.device}")
    kernel_body(s, c, heads)
    return _TinySeq.apply(q, k, v, heads, sm_scale)


class _TinySeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, heads, sm_scale):
        ctx.save_for_backward(q, k, v)
        ctx.args = (heads, sm_scale)
        m, s, c = q.shape
        o = _launch_tiny(q, k, v, m, s, heads, c // heads, sm_scale, "tiny_seq_attention (B5)")
        tiny_seq_attention.launches += 1
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return (*tiny_seq_attention_bwd(q, k, v, g, *ctx.args), None, None)


def tiny_seq_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                           heads: int, sm_scale: float):
    """Kernel B8 on its own (what `tiny_seq_attention`'s backward launches
    at S >= 8): (dq, dk, dv), each [M, S, C] in q's dtype, for output
    gradient `g`.  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel (bf16, dh % 8 == 0 up to 256, any S >= 8) or
    raises.  The streamed body (`kernel_body` "stream") takes M x H x 3 x
    S_pad floats of scratch for each row's max, 1 / sum and delta (S_pad: S
    rounded up to 64, its 64-row tiles)."""
    if q.device.type == "cpu":
        return tiny_seq_attention_bwd_plain(q, k, v, g, heads, sm_scale)
    m, s, c = q.shape
    g = g.to(q.dtype).contiguous()
    if not (q.device.type == "cuda" and k.shape == q.shape and v.shape == q.shape
            and g.shape == q.shape):
        raise ValueError(f"tiny_seq_attention backward kernel takes CUDA [M, S, H*dh]; got "
                         f"{tuple(q.shape)}, {heads} heads on {q.device}")
    body = kernel_body(s, c, heads, backward=True)
    for t in (q, k, v, g):
        if not (t.dtype == torch.bfloat16 and t.is_contiguous() and t.data_ptr() % 16 == 0):
            raise ValueError("tiny_seq_attention backward kernel takes contiguous 16-byte "
                             "aligned bf16 tensors")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lib = cuda_lib()
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr())
    shape = (m, s, heads, c // heads, float(sm_scale),
             torch.cuda.current_stream(q.device).cuda_stream)
    if body == "stream":
        stats = torch.empty(m * heads * 3 * STREAM_BWD_ROWS * -(-s // STREAM_BWD_ROWS),
                            dtype=torch.float32, device=q.device)
        err = lib.bya_tiny_seq_attention_stream_bwd(*ptrs, stats.data_ptr(), *shape)
    else:
        err = lib.bya_tiny_seq_attention_bwd(*ptrs, *shape)
    check(err, "tiny_seq_attention backward (B8)")
    tiny_seq_attention_bwd.launches += 1
    return dq, dk, dv


tiny_seq_attention.launches = 0
tiny_seq_attention_bwd.launches = 0


def pair_axis_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        heads: int, sm_scale: float) -> torch.Tensor:
    """Attention across a leading pair axis: q/k/v [B, 2, M, C] -> same; each
    (b, m, head) attends over the 2 entries of axis 1 (the identities).  A
    CPU tensor takes the plain version; a CUDA tensor launches kernel B4
    (bf16, any C that `heads` <= 128 divide) or raises.  Triton raises
    itself if a launch fails."""
    if q.device.type == "cpu":
        return pair_axis_attention_plain(q, k, v, heads, sm_scale)
    return kernel_with_plain_vjp(_pair_kernel, pair_axis_attention_plain, (q, k, v),
                                 (heads, sm_scale))


def pair_blocks(c: int, heads: int) -> tuple:
    """B4's launch shape for [B, 2, M, C] over `heads` heads: (DP, HB,
    BLOCK_M), the head width and the heads a program takes padded to powers
    of two (Triton's blocks), and the rows a program takes, so that a
    program's operand tiles hold about 4,096 elements; a grid column per
    HB heads.  Raises ValueError past JAX's 128 heads, naming ROADMAP.md
    C4 (JAX's kernel computes those heads wrong)."""
    if heads < 1 or heads > PAIR_MAX_HEADS or c % heads != 0:
        raise ValueError(f"pair_axis_attention kernel takes C split into 1..{PAIR_MAX_HEADS} "
                         f"heads (the JAX kernel's head indicator is {PAIR_MAX_HEADS} wide and "
                         f"computes more heads wrong: ROADMAP.md C4); got C = {c}, {heads} heads")
    p2 = lambda n: 1 << (n - 1).bit_length()
    dp = p2(c // heads)
    hb = min(p2(heads), max(1, 4096 // dp))
    return dp, hb, max(1, 4096 // (hb * dp))


def _pair_kernel(q, k, v, heads: int, sm_scale: float) -> torch.Tensor:
    b, s, m, c = q.shape
    dp, hb, block_m = pair_blocks(c, heads)
    ok = (q.device.type == "cuda" and s == 2 and k.shape == q.shape and v.shape == q.shape
          and all(t.dtype == torch.bfloat16 and t.is_contiguous() for t in (q, k, v)))
    if not ok:
        raise ValueError(f"pair_axis_attention kernel takes contiguous bf16 CUDA [B, 2, M, C]; "
                         f"got {tuple(q.shape)} {q.dtype}, {heads} heads on {q.device}")
    import_triton()
    from ._pair_triton import pair_attention_kernel

    o = torch.empty_like(q)
    pair_attention_kernel[(-(-m // block_m), -(-heads // hb), b)](
        q, k, v, o, m, float(sm_scale), C=c, HEADS=heads, DH=c // heads, DP=dp, HB=hb,
        BLOCK_M=block_m, num_warps=8)
    pair_axis_attention.launches += 1
    return o


pair_axis_attention.launches = 0

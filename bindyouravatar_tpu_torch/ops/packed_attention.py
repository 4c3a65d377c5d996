"""Attention over tiny sequences for the router's STABs: kernels B4, B5, B5'.

The MultiIPRouter's temporal and multi-ID attentions run over tiny
sequences with huge batches: temporal over S = 13 latent frames for 5,400
rows, multi-ID over the S = 2 identities for 2 x 17,550 rows (dim 512,
8 heads of 64).  Each replaces a TPU kernel of
`bindyouravatar_tpu/ops/packed_attention.py`:
  * `tiny_seq_attention` (B5, `_slice_kernel`): channel-packed [M, S, C],
    S >= 8; CUDA C++ (`csrc/packed_attention.cu`).
  * `packed_head_attention` (B5', `_kernel`, the packed-head fold): the
    same function on [M, S*H, D] for S < 8; the B5 kernel instantiated for
    small S (the operand is the same memory as [M, S, H*D]).
  * `pair_axis_attention` (B4, `_pair_kernel`): attention across a leading
    pair axis [B, 2, M, C] as the closed-form 2-way softmax
    o_i = v0 + sigmoid(s_i1 - s_i0) (v1 - v0); Triton (`_pair_triton.py`).
Each has its plain PyTorch version, which a CPU tensor takes; a CUDA tensor
launches the kernel or raises.  The source notes say what bounds them.
"""

from __future__ import annotations

import torch

from ._build import check, cuda_lib, import_triton

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
_MAX_S = 16          # sequence lengths the B5 kernel is instantiated for


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
    """The B5 kernel on [M, S, H*D] memory (shape checks done by the caller)."""
    for t in (q, k, v):
        if not (t.dtype == torch.bfloat16 and t.is_contiguous() and t.data_ptr() % 16 == 0):
            raise ValueError(f"{what} kernel takes contiguous 16-byte aligned bf16 tensors")
    o = torch.empty_like(q)
    err = cuda_lib().bya_tiny_seq_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), m, s, heads, d,
        float(sm_scale), torch.cuda.current_stream(q.device).cuda_stream)
    check(err, what)
    return o


def packed_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          heads: int, sm_scale: float) -> torch.Tensor:
    """Multi-head self-attention over a tiny packed axis: q/k/v [M, S*H, D]
    with packing (s, h) -> s*H + h (the reshape of [M, S, H, D]) -> the
    same.  A CPU tensor takes the plain version; a CUDA tensor launches
    kernel B5' (bf16, D = 64, S <= 16) or raises."""
    if q.device.type == "cpu":
        return packed_head_attention_plain(q, k, v, heads, sm_scale)
    m, sh, d = q.shape
    if not (q.device.type == "cuda" and d == 64 and sh % heads == 0
            and 1 <= sh // heads <= _MAX_S and k.shape == q.shape and v.shape == q.shape):
        raise ValueError(f"packed_head_attention kernel takes CUDA [M, S*H, 64] with "
                         f"S <= {_MAX_S}; got {tuple(q.shape)}, {heads} heads on {q.device}")
    o = _launch_tiny(q, k, v, m, sh // heads, heads, d, sm_scale, "packed_head_attention (B5')")
    packed_head_attention.launches += 1
    return o


packed_head_attention.launches = 0


def tiny_seq_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       heads: int, sm_scale: float) -> torch.Tensor:
    """Multi-head self-attention over a tiny sequence, channel-packed IO:
    q/k/v [M, S, C] (C = heads * dh, h-major) -> [M, S, C].  A CPU tensor
    takes the plain version; on a CUDA tensor S < 8 goes to
    `packed_head_attention` (B5', as the JAX dispatch does), S >= 8
    launches kernel B5 (bf16, dh = 64, S <= 16), and anything else raises."""
    if q.device.type == "cpu":
        return tiny_seq_attention_plain(q, k, v, heads, sm_scale)
    m, s, c = q.shape
    if s < 8:
        dh = c // heads
        o = packed_head_attention(q.reshape(m, s * heads, dh), k.reshape(m, s * heads, dh),
                                  v.reshape(m, s * heads, dh), heads, sm_scale)
        return o.reshape(m, s, c)
    if not (q.device.type == "cuda" and c == heads * 64 and s <= _MAX_S
            and k.shape == q.shape and v.shape == q.shape):
        raise ValueError(f"tiny_seq_attention kernel takes CUDA [M, S, H*64] with "
                         f"S <= {_MAX_S}; got {tuple(q.shape)}, {heads} heads on {q.device}")
    o = _launch_tiny(q, k, v, m, s, heads, 64, sm_scale, "tiny_seq_attention (B5)")
    tiny_seq_attention.launches += 1
    return o


tiny_seq_attention.launches = 0


def pair_axis_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        heads: int, sm_scale: float) -> torch.Tensor:
    """Attention across a leading pair axis: q/k/v [B, 2, M, C] -> same; each
    (b, m, head) attends over the 2 entries of axis 1 (the identities).  A
    CPU tensor takes the plain version; a CUDA tensor launches kernel B4
    (bf16, C and C / heads powers of two, C <= 1024) or raises.  Triton
    raises itself if a launch fails."""
    if q.device.type == "cpu":
        return pair_axis_attention_plain(q, k, v, heads, sm_scale)
    b, s, m, c = q.shape
    pow2 = lambda n: n > 0 and n & (n - 1) == 0
    ok = (q.device.type == "cuda" and s == 2 and c <= 1024 and pow2(c) and c % heads == 0
          and pow2(c // heads) and k.shape == q.shape and v.shape == q.shape
          and all(t.dtype == torch.bfloat16 and t.is_contiguous() for t in (q, k, v)))
    if not ok:
        raise ValueError(f"pair_axis_attention kernel takes contiguous bf16 CUDA [B, 2, M, C] "
                         f"with C and C/heads powers of two, C <= 1024; got "
                         f"{tuple(q.shape)} {q.dtype}, {heads} heads on {q.device}")
    import_triton()
    from ._pair_triton import pair_attention_kernel

    o = torch.empty_like(q)
    block_m = max(1, 4096 // c)
    pair_attention_kernel[(-(-m // block_m), b)](
        q, k, v, o, m, float(sm_scale), C=c, HEADS=heads, DH=c // heads, BLOCK_M=block_m,
        num_warps=8)
    pair_axis_attention.launches += 1
    return o


pair_axis_attention.launches = 0

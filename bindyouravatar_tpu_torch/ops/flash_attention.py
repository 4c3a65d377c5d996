"""Flat flash attention: kernels B1 (inference forward with fused QK-LN and
RoPE) and B7 (the differentiable training attention: forward saving the
LSE, and the dq/dk/dv backward).

The kernels (`csrc/flash_attention.cu`) replace the TPU kernels
`_fwd_flat_t_kernel` (B1), `_fwd_flat_kernel` and `_bwd_flat_kernel` (B7,
the `_flash_flat` custom vjp) of `bindyouravatar_tpu/ops/flash_attention.py`;
the source note says what bounds them on the H100 and how they are built.
Unlike the TPU path, V arrives in the projections' own [B, S, H*D] layout,
the output and the gradients leave in it, and the sequence is not padded:
the kernels mask the ragged tail themselves.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ._build import check, cuda_lib
from .attention import sdpa
from .rope import apply_rotary_emb

QK_NORM_EPS = 1e-6


def _head_layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    c = x32 - mean
    var = (c * c).mean(-1, keepdim=True)
    return (c * torch.rsqrt(var + QK_NORM_EPS) * scale.float() + bias.float()).to(x.dtype)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                          scale: Optional[float] = None, kv_len: Optional[int] = None,
                          rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                          rope_start: int = 0,
                          qk_norm: Optional[Tuple[torch.Tensor, ...]] = None,
                          block_q: int = 1024) -> torch.Tensor:
    """Plain version of B1 (the JAX package's XLA fallback math): per-head
    LN -> dtype, RoPE -> dtype, fp32-softmax attention, flat out."""
    b, s, hd = q.shape
    d = hd // heads
    split = lambda x: x.reshape(b, s, heads, d).transpose(1, 2)    # [B,H,S,D]
    q, k, v = split(q), split(k), split(v)
    if qk_norm is not None:
        qs, qb, ks, kb = qk_norm
        q, k = _head_layernorm(q, qs, qb), _head_layernorm(k, ks, kb)
    if rope is not None:
        cos, sin = rope
        end = rope_start + cos.shape[0]
        rot = lambda x: torch.cat([x[..., :rope_start, :],
                                   apply_rotary_emb(x[..., rope_start:end, :], cos, sin),
                                   x[..., end:, :]], dim=-2)
        q, k = rot(q), rot(k)
    out = sdpa(q, k, v, scale=scale, kv_len=kv_len, block_q=block_q)
    return out.transpose(1, 2).reshape(b, s, hd)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                    scale: Optional[float] = None, kv_len: Optional[int] = None,
                    rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    rope_start: int = 0,
                    qk_norm: Optional[Tuple[torch.Tensor, ...]] = None) -> torch.Tensor:
    """Non-causal attention over flat q/k/v [B, S, H*D] -> [B, S, H*D].

    `qk_norm=(q_scale, q_bias, k_scale, k_bias)` ([D] each) applies the
    per-head LayerNorm (eps 1e-6, fp32 stats); `rope=(cos, sin)` ([R, D])
    rotates rows [rope_start, rope_start + R) after it; kv rows >= kv_len
    are masked.  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel (bf16, D = 64) or raises."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, heads, scale, kv_len, rope, rope_start, qk_norm)
    b, s, hd = q.shape
    d = hd // heads
    if scale is None:
        scale = d ** -0.5
    if kv_len is None:
        kv_len = s
    _check_flat(q, k, v, heads, kv_len)
    dev = q.device
    f32 = lambda t: t.to(device=dev, dtype=torch.float32).contiguous()
    ln = [None] * 4 if qk_norm is None else [f32(a) for a in qk_norm]
    cos, sin, rope_rows = _rope_tables(rope, rope_start, s, d, dev)
    o = torch.empty_like(q)
    q_prep, k_prep = torch.empty_like(q), torch.empty_like(k)
    ptr = lambda t: None if t is None else t.data_ptr()
    err = cuda_lib().bya_flash_attention_flat(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), q_prep.data_ptr(),
        k_prep.data_ptr(), *[ptr(a) for a in ln], ptr(cos), ptr(sin), rope_start,
        rope_rows, b, s, heads, kv_len, float(scale), QK_NORM_EPS, None,
        torch.cuda.current_stream(dev).cuda_stream)
    check(err, "flash_attention (B1)")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise ValueError(f"flash_attention kernel: {what}")


def _rope_tables(rope, rope_start: int, s: int, d: int, dev: torch.device):
    """(cos, sin, rope_rows) as contiguous fp32 on `dev`, or (None, None, 0)."""
    if rope is None:
        return None, None, 0
    cos, sin = (t.to(device=dev, dtype=torch.float32).contiguous() for t in rope)
    rows = cos.shape[0]
    _require(cos.shape == (rows, d) and sin.shape == cos.shape and rope_start + rows <= s,
             "rope tables do not fit the sequence")
    return cos, sin, rows


def _check_flat(q, k, v, heads: int, kv_len: int) -> None:
    b, s, hd = q.shape
    d = hd // heads
    _require(q.device.type == "cuda", f"tensors on {q.device}")
    _require(d == 64 and hd == heads * d, f"head dim {hd}/{heads}, kernel takes 64")
    _require(k.shape == q.shape and v.shape == q.shape, "q, k, v shapes differ")
    _require(0 < kv_len <= s, f"kv_len {kv_len} outside (0, {s}]")
    for t in (q, k, v):
        _require(t.dtype == torch.bfloat16 and t.is_contiguous()
                 and t.data_ptr() % 16 == 0, "q, k, v must be contiguous 16-byte aligned bf16")


def _rope_qk(q: torch.Tensor, k: torch.Tensor, rope, rope_start: int, sign: float = 1.0):
    """Rotate rows [rope_start, rope_start + R) of [B, H, S, D] q and k
    (`sign=-1`: the adjoint rotation, sin negated); other rows unchanged."""
    if rope is None:
        return q, k
    cos, sin = rope
    end = rope_start + cos.shape[0]
    rot = lambda x: torch.cat([x[..., :rope_start, :],
                               apply_rotary_emb(x[..., rope_start:end, :], cos, sign * sin),
                               x[..., end:, :]], dim=-2)
    return rot(q), rot(k)


def flash_attention_flat_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                   heads: int, scale: Optional[float] = None,
                                   kv_len: Optional[int] = None,
                                   rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                                   rope_start: int = 0, block_q: int = 1024):
    """Plain version of B7's forward: RoPE -> dtype, fp32-softmax attention
    (p rounded to v's dtype for the PV product), flat out, and the per-row
    natural LSE of the scaled scores, fp32 [B, H, S]."""
    b, s, hd = q.shape
    d = hd // heads
    scale = d ** -0.5 if scale is None else scale
    split = lambda x: x.reshape(b, s, heads, d).transpose(1, 2)    # [B,H,S,D]
    qh, kh = _rope_qk(split(q), split(k), rope, rope_start)
    vh = split(v)
    kf = kh.float().transpose(-1, -2)
    valid = torch.arange(s, device=q.device) < (s if kv_len is None else kv_len)
    outs, lses = [], []
    for i in range(0, s, block_q):
        sc = torch.matmul(qh[..., i:i + block_q, :].float(), kf) * scale
        sc = sc.masked_fill(~valid, float("-inf"))
        lse = torch.logsumexp(sc, dim=-1)
        outs.append(torch.matmul(torch.exp(sc - lse[..., None]).to(v.dtype), vh))
        lses.append(lse)
    o = torch.cat(outs, dim=-2).transpose(1, 2).reshape(b, s, hd)
    return o, torch.cat(lses, dim=-1)


def flash_attention_flat_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                   do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                                   heads: int, scale: Optional[float] = None,
                                   kv_len: Optional[int] = None,
                                   rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                                   rope_start: int = 0, block_q: int = 1024):
    """Plain version of B7's backward: the explicit flash-backward math from
    (q, k, v, dO, lse, delta = rowsum(o * dO)) -- P = exp(s - lse) with the
    masked kv rows exactly 0, dV = P^T dO, dS = P (dO V^T - delta) rounded to
    q's dtype, dq = dS k scale, dk = dS^T q scale on the rotated q and k --
    then the RoPE adjoint (cos, -sin) on dq and dk.  Flat [B, S, H*D] out."""
    b, s, hd = q.shape
    d = hd // heads
    scale = d ** -0.5 if scale is None else scale
    split = lambda x: x.reshape(b, s, heads, d).transpose(1, 2)
    merge = lambda x: x.transpose(1, 2).reshape(b, s, hd).to(q.dtype)
    qh, kh = _rope_qk(split(q), split(k), rope, rope_start)
    vh, doh = split(v).float(), split(do).float()
    kf = kh.float()
    valid = torch.arange(s, device=q.device) < (s if kv_len is None else kv_len)
    dq_parts = []
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vh)
    for i in range(0, s, block_q):
        sl = slice(i, i + block_q)
        qb = qh[..., sl, :].float()
        p = torch.exp(torch.matmul(qb, kf.transpose(-1, -2)) * scale - lse[..., sl, None])
        p = p.masked_fill(~valid, 0.0)
        dv += torch.matmul(p.to(q.dtype).float().transpose(-1, -2), doh[..., sl, :])
        dp = torch.matmul(doh[..., sl, :], vh.transpose(-1, -2))
        ds = (p * (dp - delta[..., sl, None])).to(q.dtype).float()
        dq_parts.append(torch.matmul(ds, kf) * scale)
        dk += torch.matmul(ds.transpose(-1, -2), qb) * scale
    dq, dk = _rope_qk(torch.cat(dq_parts, dim=-2), dk, rope, rope_start, sign=-1.0)
    return merge(dq), merge(dk), merge(dv)


def flash_attention_flat_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                             scale: Optional[float] = None, kv_len: Optional[int] = None,
                             rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                             rope_start: int = 0):
    """Kernel B7's forward on its own: (o [B, S, H*D], lse fp32 [B, H, S]).
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (bf16, D = 64) or raises."""
    if q.device.type == "cpu":
        return flash_attention_flat_fwd_plain(q, k, v, heads, scale, kv_len, rope, rope_start)
    b, s, hd = q.shape
    d = hd // heads
    scale = d ** -0.5 if scale is None else scale
    kv_len = s if kv_len is None else kv_len
    _check_flat(q, k, v, heads, kv_len)
    cos, sin, rope_rows = _rope_tables(rope, rope_start, s, d, q.device)
    o = torch.empty_like(q)
    lse = torch.empty((b, heads, s), dtype=torch.float32, device=q.device)
    q_prep, k_prep = torch.empty_like(q), torch.empty_like(k)
    ptr = lambda t: None if t is None else t.data_ptr()
    err = cuda_lib().bya_flash_attention_flat(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), q_prep.data_ptr(),
        k_prep.data_ptr(), None, None, None, None, ptr(cos), ptr(sin), rope_start, rope_rows,
        b, s, heads, kv_len, float(scale), 0.0, lse.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "flash_attention_flat forward (B7)")
    flash_attention_flat_fwd.launches += 1
    return o, lse


def flash_attention_flat_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                             heads: int, scale: Optional[float] = None,
                             kv_len: Optional[int] = None,
                             rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                             rope_start: int = 0):
    """Kernel B7's backward on its own: (dq, dk, dv), each [B, S, H*D] in
    q's dtype.  A CPU tensor takes the plain version; a CUDA tensor launches
    the kernels (bf16, D = 64) or raises."""
    if q.device.type == "cpu":
        return flash_attention_flat_bwd_plain(q, k, v, do, lse, delta, heads, scale, kv_len,
                                              rope, rope_start)
    b, s, hd = q.shape
    d = hd // heads
    scale = d ** -0.5 if scale is None else scale
    kv_len = s if kv_len is None else kv_len
    _check_flat(q, k, v, heads, kv_len)
    do = do.to(q.dtype).contiguous()
    _require(do.shape == q.shape and lse.shape == (b, heads, s) and delta.shape == lse.shape,
             "dO, lse or delta shape")
    lse, delta = lse.float().contiguous(), delta.float().contiguous()
    cos, sin, rope_rows = _rope_tables(rope, rope_start, s, d, q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    q_prep, k_prep = torch.empty_like(q), torch.empty_like(k)
    ptr = lambda t: None if t is None else t.data_ptr()
    err = cuda_lib().bya_flash_attention_flat_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), q_prep.data_ptr(),
        k_prep.data_ptr(), ptr(cos), ptr(sin), rope_start, rope_rows, b, s, heads, kv_len,
        float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "flash_attention_flat backward (B7)")
    flash_attention_flat_bwd.launches += 1
    return dq, dk, dv


flash_attention_flat_fwd.launches = 0
flash_attention_flat_bwd.launches = 0


def attention_delta(o: torch.Tensor, do: torch.Tensor, heads: int) -> torch.Tensor:
    """delta = rowsum(o * dO) per head, fp32 [B, H, S] (the JAX package
    computes it in XLA, outside the backward kernel)."""
    b, s, hd = o.shape
    return (o.float() * do.float()).reshape(b, s, heads, hd // heads).sum(-1).transpose(1, 2)


class _FlashFlat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, heads, scale, kv_len, rope, rope_start):
        o, lse = flash_attention_flat_fwd(q, k, v, heads, scale, kv_len, rope, rope_start)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (heads, scale, kv_len, rope, rope_start)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        heads = ctx.args[0]
        dq, dk, dv = flash_attention_flat_bwd(q, k, v, do, lse, attention_delta(o, do, heads),
                                              *ctx.args)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_flat(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                         scale: Optional[float] = None, kv_len: Optional[int] = None,
                         rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                         rope_start: int = 0) -> torch.Tensor:
    """Differentiable non-causal attention over flat q/k/v [B, S, H*D] ->
    [B, S, H*D] with optional rotate-half RoPE on rows [rope_start,
    rope_start + R) and kv rows >= kv_len masked (no QK LayerNorm: the
    training path applies it outside, as the JAX `_flash_flat` does).  A
    CPU tensor takes the plain version (autograd differentiates it); a CUDA
    tensor launches kernel B7's forward, and its backward B7's backward."""
    if q.device.type == "cpu":
        return flash_attention_flat_fwd_plain(q, k, v, heads, scale, kv_len, rope,
                                              rope_start)[0]
    return _FlashFlat.apply(q.contiguous(), k.contiguous(), v.contiguous(), heads, scale,
                            kv_len, rope, rope_start)

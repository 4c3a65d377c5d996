"""Flat flash-attention forward with fused QK-LN and RoPE: kernel B1.

The kernel (`csrc/flash_attention.cu`) replaces the TPU kernel
`_fwd_flat_t_kernel` of `bindyouravatar_tpu/ops/flash_attention.py`; its
source note says what bounds it on the H100 and how it is built.  Unlike
the TPU path, V arrives in the projections' own [B, S, H*D] layout, the
output leaves in it, and the sequence is not padded: the kernel masks the
ragged tail itself.
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
    _require(q.device.type == "cuda", f"tensors on {q.device}")
    _require(d == 64 and hd == heads * d, f"head dim {hd}/{heads}, kernel takes 64")
    _require(k.shape == q.shape and v.shape == q.shape, "q, k, v shapes differ")
    _require(0 < kv_len <= s, f"kv_len {kv_len} outside (0, {s}]")
    for t in (q, k, v):
        _require(t.dtype == torch.bfloat16 and t.is_contiguous()
                 and t.data_ptr() % 16 == 0, "q, k, v must be contiguous 16-byte aligned bf16")

    dev = q.device
    f32 = lambda t: t.to(device=dev, dtype=torch.float32).contiguous()
    ln = [None] * 4 if qk_norm is None else [f32(a) for a in qk_norm]
    cos = sin = None
    rope_rows = 0
    if rope is not None:
        cos, sin = f32(rope[0]), f32(rope[1])
        rope_rows = cos.shape[0]
        _require(cos.shape == (rope_rows, d) and sin.shape == cos.shape
                 and rope_start + rope_rows <= s, "rope tables do not fit the sequence")
    o = torch.empty_like(q)
    q_prep, k_prep = torch.empty_like(q), torch.empty_like(k)
    ptr = lambda t: None if t is None else t.data_ptr()
    err = cuda_lib().bya_flash_attention_flat(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), q_prep.data_ptr(),
        k_prep.data_ptr(), *[ptr(a) for a in ln], ptr(cos), ptr(sin), rope_start,
        rope_rows, b, s, heads, kv_len, float(scale), QK_NORM_EPS,
        torch.cuda.current_stream(dev).cuda_stream)
    check(err, "flash_attention (B1)")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise ValueError(f"flash_attention kernel: {what}")

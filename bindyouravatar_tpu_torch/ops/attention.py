"""Attention: plain scaled-dot-product attention and the layout dispatcher.

Port of `bindyouravatar_tpu/ops/attention.py`: `attention` takes JAX's
`layout` argument and JAX's dispatch rule.  A sequence of at least 1,024
rows with as many kv rows as q rows goes to `flash_attention`: the
projections' flat [B, S, H*D] layout (`"flat"`, with `heads`) to kernel B1
(B7 under grad), [B, H, S, D] (`"bhsd"`, the default) and [B, S, H, D]
(`"bshd"`) to `flash_attention_layout` (B11, differentiable through
B12 + B13 unless the QK LayerNorm is fused).  Anything else takes `sdpa`,
JAX's XLA math, after the QK LayerNorm and RoPE, as JAX's fallback does.
Each kernel path computes on the CPU through its plain version; `sdpa` is
that plain math, chunked over queries so full sequences fit in memory.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         scale: Optional[float] = None, kv_len: Optional[int] = None,
         block_q: int = 1024) -> torch.Tensor:
    """softmax(q k^T * scale) v over [..., S, D], fp32 scores and softmax,
    p rounded to v's dtype for the PV product (the JAX `sdpa`).  kv rows
    >= kv_len are masked; queries go in blocks of `block_q` rows."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    kf = k.float().transpose(-1, -2)
    mask = None
    if kv_len is not None and kv_len < k.shape[-2]:
        mask = torch.arange(k.shape[-2], device=k.device) >= kv_len
    outs = []
    for i in range(0, q.shape[-2], block_q):
        s = torch.matmul(q[..., i:i + block_q, :].float(), kf) * scale
        if mask is not None:
            s = s.masked_fill(mask, float("-inf"))
        p = torch.softmax(s, dim=-1)
        outs.append(torch.matmul(p.to(v.dtype), v))
    return torch.cat(outs, dim=-2)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: Optional[float] = None, kv_len: Optional[int] = None,
              rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              rope_start: int = 0, layout: str = "bhsd",
              qk_norm: Optional[Tuple[torch.Tensor, ...]] = None,
              heads: Optional[int] = None, name: str = "") -> torch.Tensor:
    """Self/cross attention over [B, H, S, D] (`layout="bhsd"`), [B, S, H,
    D] (`"bshd"`) or flat [B, S, H*D] (`"flat"`, pass `heads`) q/k/v,
    output in the input's layout, with optional per-head QK LayerNorm and
    rotate-half RoPE on the rows [rope_start, rope_start + len(table)) of q
    and of k.  The flash kernels take the call when the sequence axis has
    at least 1,024 rows and q and k have as many (see `flash_attention`),
    as in JAX; otherwise `sdpa` (any head dim, Sq != Skv allowed).  The JAX
    keywords that only choose between its TPU kernel and its XLA fallback
    (`use_flash`, `v_transposed`, `out_transposed`) have no counterpart
    here.  `name` tags the flash kernels' differentiable forward for
    `keep_attention` (`flash_attention`)."""
    from .flash_attention import _head_layernorm, _rope_qk, flash_attention

    if layout not in ("flat", "bhsd", "bshd"):
        raise ValueError(f"layout {layout!r}: expected 'flat', 'bhsd' or 'bshd'")
    seq = 2 if layout == "bhsd" else 1
    if q.shape[seq] >= 1024 and q.shape[seq] == k.shape[seq]:
        return flash_attention(q, k, v, heads, scale=scale, kv_len=kv_len, rope=rope,
                               rope_start=rope_start, qk_norm=qk_norm, layout=layout,
                               name=name)
    if layout == "flat":
        split = lambda t: t.reshape(t.shape[0], t.shape[1], heads, -1).transpose(1, 2)
        out = attention(split(q), split(k), split(v), scale, kv_len, rope, rope_start, "bhsd",
                        qk_norm)
        return out.transpose(1, 2).reshape(q.shape[0], q.shape[1], -1)
    if layout == "bshd":
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    if qk_norm is not None:
        qs, qb, ks, kb = qk_norm
        q, k = _head_layernorm(q, qs, qb), _head_layernorm(k, ks, kb)
    q, k = _rope_qk(q, k, rope, rope_start)
    out = sdpa(q, k, v, scale, kv_len)
    return out.transpose(1, 2) if layout == "bshd" else out

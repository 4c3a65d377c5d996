"""Attention: plain scaled-dot-product attention and the layout dispatcher.

Port of `bindyouravatar_tpu/ops/attention.py`: `attention` takes JAX's
`layout` argument.  The projections' flat [B, S, H*D] layout (`"flat"`,
with `heads`) goes to kernel B1 (`flash_attention`, inference only);
[B, H, S, D] (`"bhsd"`, the default) and [B, S, H, D] (`"bshd"`) go to
`flash_attention_layout` (B11, differentiable through B12 + B13 unless the
QK LayerNorm is fused).  Each computes on the CPU through its plain
version; `sdpa` is that plain math, chunked over queries so full
sequences fit in memory.
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
              heads: Optional[int] = None) -> torch.Tensor:
    """Non-causal self-attention over [B, H, S, D] (`layout="bhsd"`),
    [B, S, H, D] (`"bshd"`) or flat [B, S, H*D] (`"flat"`, pass `heads`)
    q/k/v, output in the input's layout, with optional fused per-head QK
    LayerNorm and rotate-half RoPE on the rows [rope_start, rope_start +
    len(table)); see `flash_attention`.  The JAX keywords that only choose
    between its TPU kernel and its XLA fallback (`use_flash`,
    `v_transposed`, `out_transposed`) have no counterpart here."""
    from .flash_attention import flash_attention

    return flash_attention(q, k, v, heads, scale=scale, kv_len=kv_len, rope=rope,
                           rope_start=rope_start, qk_norm=qk_norm, layout=layout)

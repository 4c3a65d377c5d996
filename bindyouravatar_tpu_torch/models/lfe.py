"""LocalFacialExtractor in torch (port of `bindyouravatar_tpu/models/lfe.py`).

A perceiver resampler fusing the ArcFace + CLIP identity embedding with 5
multi-scale EVA-CLIP hidden states into 32 face tokens per identity, batched
over (batch x identity).  It runs once per clip, so it holds no kernel:
plain LayerNorms (`fused=False`, as in JAX), matrix products and an fp32
softmax.  Parameter names follow the flax tree (`attn_{i}`, `ff_{i}`,
`mapping_{i}`, `id_embedding_mapping`, `latents`, `proj_out`); `latents`
[1, Q, dim] and `proj_out` [dim, out] are raw params kept in the JAX
orientation, so the converter moves them as they are.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import LFEConfig
from .layers import Dense, LayerNorm


class PerceiverAttention(nn.Module):
    """LFE inner attention: q from the latents, k/v (one fused `to_kv`) over
    concat(context, latents); fp32 scores and softmax, p rounded to v's
    dtype."""

    def __init__(self, dim: int, dim_head: int = 64, heads: int = 16,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim_head, self.heads = dim_head, heads
        inner = dim_head * heads
        kw = dict(compute_dtype=compute_dtype, dtype=dtype)
        self.norm1 = LayerNorm(dim, dtype=dtype)
        self.norm2 = LayerNorm(dim, dtype=dtype)
        self.to_q = Dense(dim, inner, bias=False, **kw)
        self.to_kv = Dense(dim, 2 * inner, bias=False, **kw)
        self.to_out = Dense(inner, dim, bias=False, **kw)

    def forward(self, x: torch.Tensor, latents: torch.Tensor) -> torch.Tensor:
        x = self.norm1(x)
        latents = self.norm2(latents)
        b, n2, _ = latents.shape
        q = self.to_q(latents)
        k, v = self.to_kv(torch.cat([x, latents], dim=-2)).chunk(2, dim=-1)
        heads = lambda t: t.reshape(b, t.shape[1], self.heads, self.dim_head).transpose(1, 2)
        q, k, v = heads(q), heads(k), heads(v)
        s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * self.dim_head ** -0.5
        p = torch.softmax(s, dim=-1).to(v.dtype)
        o = torch.matmul(p, v).transpose(1, 2).reshape(b, n2, -1)
        return self.to_out(o)


class _MappingMLP(nn.Module):
    """Linear-LN-LeakyReLU x2 -> Linear (reference mapping_{i} / id mapping)."""

    def __init__(self, in_dim: int, hidden: int, out: int,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        kw = dict(compute_dtype=compute_dtype, dtype=dtype)
        self.fc0 = Dense(in_dim, hidden, **kw)
        self.ln0 = LayerNorm(hidden, dtype=dtype)
        self.fc1 = Dense(hidden, hidden, **kw)
        self.ln1 = LayerNorm(hidden, dtype=dtype)
        self.fc_out = Dense(hidden, out, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.leaky_relu(self.ln0(self.fc0(x)), 0.01)
        x = F.leaky_relu(self.ln1(self.fc1(x)), 0.01)
        return self.fc_out(x)


class _FeedForward(nn.Module):
    """LN -> Linear(no bias) -> GELU -> Linear(no bias) (router.py:10-17)."""

    def __init__(self, dim: int, mult: int = 4, compute_dtype: torch.dtype = torch.bfloat16,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        kw = dict(compute_dtype=compute_dtype, dtype=dtype)
        self.norm = LayerNorm(dim, dtype=dtype)
        self.fc1 = Dense(dim, dim * mult, bias=False, **kw)
        self.fc2 = Dense(dim * mult, dim, bias=False, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(self.norm(x))))


class LocalFacialExtractor(nn.Module):
    """id_embed [N, id_embed_dim], vit_hidden [N, scales, T, vit_dim] ->
    face tokens [N, num_queries, output_dim]."""

    def __init__(self, cfg: LFEConfig = LFEConfig(), compute_dtype: torch.dtype = torch.bfloat16,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg, self.compute_dtype = cfg, compute_dtype
        c, kw = cfg, dict(compute_dtype=compute_dtype, dtype=dtype)
        self.latents = nn.Parameter(torch.empty(1, c.num_queries, c.dim, dtype=dtype))
        self.proj_out = nn.Parameter(torch.empty(c.dim, c.output_dim, dtype=dtype))
        self.id_embedding_mapping = _MappingMLP(c.id_embed_dim, c.dim, c.dim * c.num_id_token,
                                                **kw)
        for i in range(c.num_scales):
            self.add_module(f"mapping_{i}", _MappingMLP(c.vit_dim, c.dim, c.dim, **kw))
        for i in range(c.depth):
            self.add_module(f"attn_{i}", PerceiverAttention(c.dim, c.dim_head, c.heads, **kw))
            self.add_module(f"ff_{i}", _FeedForward(c.dim, c.ff_mult, **kw))

    @torch.no_grad()
    def init_params_(self, generator: torch.Generator) -> None:
        """The JAX init of the raw params: both ~ N(0, dim^-1/2)."""
        scale = self.cfg.dim ** -0.5
        self.latents.normal_(0.0, scale, generator=generator)
        self.proj_out.normal_(0.0, scale, generator=generator)

    def forward(self, id_embed: torch.Tensor, vit_hidden: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        n = id_embed.shape[0]
        id_tokens = self.id_embedding_mapping(id_embed).reshape(n, c.num_id_token, c.dim)
        latents = self.latents.to(self.compute_dtype).expand(n, -1, -1)
        latents = torch.cat([latents, id_tokens], dim=1)
        depth_per_scale = c.depth // c.num_scales
        for i in range(c.num_scales):
            vit_feat = getattr(self, f"mapping_{i}")(vit_hidden[:, i])
            ctx = torch.cat([id_tokens, vit_feat], dim=1)
            for j in range(i * depth_per_scale, (i + 1) * depth_per_scale):
                latents = getattr(self, f"attn_{j}")(ctx, latents) + latents
                latents = getattr(self, f"ff_{j}")(latents) + latents
        return latents[:, :c.num_queries] @ self.proj_out.to(self.compute_dtype)

"""Face injection and the MultiIPRouter in torch (port of
`bindyouravatar_tpu/models/router.py`).

  * `PerceiverCrossAttention`: video queries attend to each identity's face
    tokens through kernel B2; q stays in the to_q projection's flat
    [B, S, H*dh] layout and is handed, with k, to the router (h-major
    packing f = h*dh + d, as in JAX).
  * `RouterNorms` (shared), `MultiIPRouterLayerProj` (one per face layer).
  * `MultiIPRouterTrunk` (shared): per-head re-attention features, LayerNorm,
    the 3D sincos pos-emb on the canonical (T, H, W) grid, 4 STABs
    (spatial attention through B7 -- or bare B1 when the DiT is
    inference-configured -- without LN or RoPE, temporal through B5/B5',
    multi-ID through B4, MLP) and `MulReduceDense` -> routing [B, S, I] in
    [0, 1].
Every LayerNorm the JAX package marks `fused=True` is one here (kernel B6
for widths that are multiples of 128).  Parameter names follow the flax
tree, so `convert.jax_params_to_torch` maps them one to one.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import RouterConfig
from ..ops.attention import attention, sdpa
from ..ops.flash_attention import MAX_HEAD_DIM, flash_attention_flat, flat_heads_pack
from ..ops.packed_attention import pair_axis_attention, tiny_seq_attention
from ..ops.short_kv_attention import short_kv_attention_flat
from .layers import Dense, LayerNorm


class PerceiverCrossAttention(nn.Module):
    """Face feature injection attention: face tokens [B, I, n_tok, kv_dim],
    video tokens [B, S, dim] -> (id_feat, q_flat [B, S, H*dh], k_flat
    [B, I, n_tok, H*dh]).  id_feat is [B, I, S, dim] normally, or the
    per-identity features before `to_out`, [B, I, S, H*dh], with
    `return_pre_out` (the caller combines the identities with the routing
    weights first and projects once; JAX returns them head-major
    [B, I, H, S, dh], the same values)."""

    def __init__(self, dim: int = 3072, dim_head: int = 128, heads: int = 16,
                 kv_dim: int = 2048, return_pre_out: bool = False,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim_head, self.heads, self.return_pre_out = dim_head, heads, return_pre_out
        inner = dim_head * heads
        kw = dict(bias=False, compute_dtype=compute_dtype, dtype=dtype)
        self.norm1 = LayerNorm(kv_dim, fused=True, dtype=dtype)
        self.norm2 = LayerNorm(dim, fused=True, dtype=dtype)
        self.to_q = Dense(dim, inner, **kw)
        self.to_k = Dense(kv_dim, inner, **kw)
        self.to_v = Dense(kv_dim, inner, **kw)
        self.to_out = Dense(inner, dim, **kw)

    def forward(self, face_tokens: torch.Tensor, video_tokens: torch.Tensor):
        b, n_id, n_tok, _ = face_tokens.shape
        x = self.norm1(face_tokens)
        q_flat = self.to_q(self.norm2(video_tokens))
        k_flat, v_flat = self.to_k(x), self.to_v(x)
        heads = lambda t: (t.reshape(b, n_id, n_tok, self.heads, self.dim_head)
                           .transpose(2, 3).contiguous())             # [B, I, H, n_tok, dh]
        o = short_kv_attention_flat(q_flat, heads(k_flat), heads(v_flat),
                                    self.dim_head ** -0.5)
        if not self.return_pre_out:
            o = self.to_out(o)
        return o, q_flat.detach(), k_flat.detach()


class SelfAttention(nn.Module):
    """MHA with biases over [B, S, dim] (the STAB spatial attention): with
    S >= 1024 and dh a multiple of 64 (JAX's `dh % 64 == 0`) the
    differentiable kernel B7 without RoPE, or with `inference` (the DiT's
    `fuse_qk_norm`, JAX `inference_vt`) bare B1, where the flat kernels take
    the heads: dh 64, 128 and 256 (at 64, an even head count); other such
    heads raise (192 does not pack into 128 lanes and JAX's flat kernels
    assert there; past 256 the port's kernels stop); otherwise the plain
    attention (the JAX dispatch, `ops/attention.py:144`, takes XLA SDPA
    there: below 1,024 rows, or at a head dim such as the 2B router's
    80)."""

    def __init__(self, dim: int, heads: int = 8, inference: bool = False,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads, self.inference = heads, inference
        kw = dict(compute_dtype=compute_dtype, dtype=dtype)
        self.to_q = Dense(dim, dim, **kw)
        self.to_k = Dense(dim, dim, **kw)
        self.to_v = Dense(dim, dim, **kw)
        self.to_out = Dense(dim, dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, dim = x.shape
        dh = dim // self.heads
        q, k, v = self.to_q(x), self.to_k(x), self.to_v(x)
        if s >= 1024 and dh % 64 == 0:
            if dh > MAX_HEAD_DIM:
                raise NotImplementedError(f"the STAB attention's flash path at head dim {dh}: "
                                          f"the flat kernels take D <= {MAX_HEAD_DIM} (wider "
                                          f"heads: ROADMAP.md queue B item 4)")
            if not flat_heads_pack(dh, self.heads):
                raise NotImplementedError(
                    f"the STAB attention's flash path at head dim {dh}: {self.heads} heads of "
                    f"{dh} do not pack into 128 lanes, which JAX's flat kernels assert "
                    f"(bindyouravatar_tpu/ops/flash_attention.py:490)")
            if self.inference:
                o = attention(q, k, v, layout="flat", heads=self.heads)
            else:
                o = flash_attention_flat(q, k, v, self.heads)
        else:
            split = lambda t: t.reshape(b, s, self.heads, dh).transpose(1, 2)
            o = sdpa(split(q), split(k), split(v)).transpose(1, 2).reshape(b, s, dim)
        return self.to_out(o)


class AxisAttention(nn.Module):
    """Self-attention along one tiny axis of a [B, I, T, H, W, C] block:
    axis 1 with I = 2 (multi-ID) through kernel B4 on the identity-leading
    [B, 2, THW, C] view; otherwise (temporal, axis 2) the axis moves next
    to the channels, [M, S, C], through `tiny_seq_attention` (B5/B5').
    Same params (to_q/to_k/to_v/to_out, biases) as `SelfAttention`."""

    def __init__(self, dim: int, axis: int, heads: int = 8,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim, self.axis, self.heads = dim, axis, heads
        kw = dict(compute_dtype=compute_dtype, dtype=dtype)
        self.to_q = Dense(dim, dim, **kw)
        self.to_k = Dense(dim, dim, **kw)
        self.to_v = Dense(dim, dim, **kw)
        self.to_out = Dense(dim, dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sh = x.shape
        scale = (self.dim // self.heads) ** -0.5
        if self.axis == 1 and sh[1] == 2:
            xf = x.reshape(sh[0], 2, -1, self.dim)
            o = pair_axis_attention(self.to_q(xf), self.to_k(xf), self.to_v(xf), self.heads,
                                    scale)
            return self.to_out(o).reshape(sh)
        perm = [j for j in range(5) if j != self.axis] + [self.axis, 5]
        xt = x.permute(perm)                                  # [batch..., S, C]
        xf = xt.reshape(-1, xt.shape[-2], self.dim)
        o = tiny_seq_attention(self.to_q(xf), self.to_k(xf), self.to_v(xf), self.heads, scale)
        o = self.to_out(o).reshape(xt.shape)
        return o.permute([int(j) for j in np.argsort(perm)])


class SpatialTemporalAttentionBlock(nn.Module):
    """Spatial, temporal and multi-ID self-attentions + MLP over
    [B, I, T, H, W, C] (reference `models/router.py:425-493`)."""

    def __init__(self, dim: int, heads: int = 8, mlp_ratio: int = 1, inference: bool = False,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        kw = dict(compute_dtype=compute_dtype, dtype=dtype)
        self.spatial_attn = SelfAttention(dim, heads, inference=inference, **kw)
        self.temporal_attn = AxisAttention(dim, axis=2, heads=heads, **kw)
        self.multi_id_attn = AxisAttention(dim, axis=1, heads=heads, **kw)
        self.norm1, self.norm2, self.norm3, self.norm4 = (
            LayerNorm(dim, fused=True, dtype=dtype) for _ in range(4))
        self.mlp_fc1 = Dense(dim, dim * mlp_ratio, **kw)
        self.mlp_fc2 = Dense(dim * mlp_ratio, dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, i, t, h, w, c = x.shape
        xs = self.norm1(x.reshape(b * i * t, h * w, c))
        x = x + self.spatial_attn(xs).reshape(x.shape)
        x = x + self.temporal_attn(self.norm2(x))
        x = x + self.multi_id_attn(self.norm3(x))
        y = self.norm4(x).reshape(-1, c)
        y = self.mlp_fc2(F.gelu(self.mlp_fc1(y)))
        return x + y.reshape(x.shape)


@functools.lru_cache(maxsize=16)
def _router_pos_emb(t: int, h: int, w: int, feat_dim: int) -> np.ndarray:
    """Additive 3D sincos pos-emb, flat [T*H*W, feat_dim] on the canonical
    (T, H, W) grid (a copy of the JAX `_router_pos_emb`, reference
    `router.py:334-362` made grid-polymorphic).  Cached: do not write to it."""
    third = feat_dim // 3

    def axis_emb(n):
        pos = np.arange(n, dtype=np.float64)[:, None]
        div = np.power(10000.0, np.arange(0, third, 2, dtype=np.float64) / third)
        ang = pos / div
        return np.stack([np.sin(ang), np.cos(ang)], axis=-1).reshape(n, -1)

    te, he, we = axis_emb(t), axis_emb(h), axis_emb(w)
    full = np.zeros((t, h, w, feat_dim), dtype=np.float32)
    d = te.shape[-1]
    full[..., :d] = te[:, None, None, :]
    full[..., d:2 * d] = he[None, :, None, :]
    full[..., 2 * d:3 * d] = we[None, None, :, :]
    return full.reshape(t * h * w, feat_dim)


class MultiIPRouterLayerProj(nn.Module):
    """Per-face-layer router projections (reference to_q[i]/to_k[i])."""

    def __init__(self, in_dim: int, q_k_dim: int = 2048,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        kw = dict(bias=False, compute_dtype=compute_dtype, dtype=dtype)
        self.to_q = Dense(in_dim, q_k_dim, **kw)
        self.to_k = Dense(in_dim, q_k_dim, **kw)

    def forward(self, q_flat: torch.Tensor, k_flat: torch.Tensor):
        return self.to_q(q_flat), self.to_k(k_flat)


class MulReduceDense(nn.Module):
    """Dense(1) as an fp32 multiply-and-sum whose logit is rounded to the
    compute dtype (`router.py:302-320`; params as nn.Dense: weight [1, d],
    bias [1])."""

    def __init__(self, dim: int, compute_dtype: torch.dtype = torch.bfloat16,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.empty(1, dim, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(1, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        logit = (x.float() * self.weight[0].float()).sum(-1) + self.bias[0].float()
        return logit.to(self.compute_dtype)


class MultiIPRouterTrunk(nn.Module):
    """Shared router trunk: q_proj [B, S, q_k_dim], k_proj [B, I, n_tok,
    q_k_dim] (layer-projected) and the (T, H, W) grid -> routing [B, S, I]
    in [0, 1], fp32."""

    def __init__(self, cfg: RouterConfig = RouterConfig(), inference: bool = False,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg, self.compute_dtype = cfg, compute_dtype
        kw = dict(compute_dtype=compute_dtype, dtype=dtype)
        self.norm = LayerNorm(cfg.feat_dim, fused=True, dtype=dtype)
        for li in range(cfg.num_attention_layers):
            self.add_module(f"st_{li}", SpatialTemporalAttentionBlock(
                cfg.feat_dim, cfg.attn_heads, cfg.mlp_ratio, inference=inference, **kw))
        self.final_proj = MulReduceDense(cfg.feat_dim, **kw)
        self._pos = {}      # (grid, device, dtype) -> the pos-emb table on the device

    def pos_emb(self, grid: Tuple[int, int, int], device: torch.device,
                dtype: torch.dtype) -> torch.Tensor:
        """The pos-emb table [T*H*W, feat_dim], copied to the device once per
        grid (not once per call: 36 MB at the 5B grid)."""
        key = (grid, device, dtype)
        if key not in self._pos:
            table = torch.from_numpy(_router_pos_emb(*grid, self.cfg.feat_dim))
            self._pos[key] = table.to(device=device, dtype=dtype)
        return self._pos[key]

    def forward(self, q_proj: torch.Tensor, k_proj: torch.Tensor,
                grid: Tuple[int, int, int]) -> torch.Tensor:
        c = self.cfg
        t, h, w = grid
        b, s, _ = q_proj.shape
        n_id, n_tok = k_proj.shape[1], k_proj.shape[2]
        nh, dh = c.num_heads, c.q_k_dim // c.num_heads
        # re-attention features, token-major and head-minor:
        # feat[b, i, s, tok*nh + h] = sum_{d in head h} q[s, h*dh+d] k[tok, h*dh+d]
        qh = q_proj.reshape(b, s, nh, dh).transpose(1, 2)                   # [B, H, S, dh]
        kh = k_proj.reshape(b, n_id * n_tok, nh, dh).permute(0, 2, 3, 1)    # [B, H, dh, I*T]
        feat = torch.matmul(qh, kh)          # [B, H, S, I*T], fp32 accumulation
        feat = feat.reshape(b, nh, s, n_id, n_tok).permute(0, 3, 2, 4, 1)
        feat = self.norm(feat.reshape(b, n_id, s, n_tok * nh))
        feat = feat + self.pos_emb(grid, feat.device, feat.dtype)
        feat = feat.reshape(b, n_id, t, h, w, c.feat_dim)
        for li in range(c.num_attention_layers):
            feat = getattr(self, f"st_{li}")(feat)
        logit = self.final_proj(feat.reshape(b, n_id, s, c.feat_dim))      # [B, I, S]
        return torch.sigmoid(logit.float()).transpose(1, 2)                # [B, S, I]


class RouterNorms(nn.Module):
    """Shared input norms before the per-layer projections (reference
    `router.py:380-383`)."""

    def __init__(self, q_k_dim: int = 2048, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm_q = LayerNorm(q_k_dim, fused=True, dtype=dtype)
        self.norm_k = LayerNorm(q_k_dim, fused=True, dtype=dtype)

    def forward(self, q_flat: torch.Tensor, k_flat: torch.Tensor):
        return self.norm_q(q_flat), self.norm_k(k_flat)

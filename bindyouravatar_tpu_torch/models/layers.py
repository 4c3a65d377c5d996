"""DiT building blocks in torch (port of `bindyouravatar_tpu/models/layers.py`).

Module and parameter names follow the flax tree (`to_q`, `norm1.linear`,
`ff.net_0`, ...) so `convert.jax_params_to_torch` maps names one to one.
Linear layers compute in the model's activation dtype, casting weights
stored in another dtype, as flax `nn.Dense(dtype=...)` does.  LayerNorm
statistics are fp32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import attention
from ..ops.flash_attention import flash_attention_flat
from ..ops.layernorm import fused_layernorm, head_layernorm, layernorm_plain


@torch.no_grad()
def init_random_(module: nn.Module, generator: torch.Generator) -> None:
    """Draw every parameter of `module` from `generator`, on its device:
    matrices and conv kernels ~ N(0, 1/fan_in) (lecun normal), norm gains
    ~ N(1, 0.1), other vectors (biases, norm shifts) ~ N(0, 0.02)."""
    gains = {id(m.weight) for m in module.modules()
             if isinstance(m, (LayerNorm, HeadLayerNorm, nn.GroupNorm)) and m.weight is not None}
    for p in module.parameters():
        if p.ndim >= 2:
            p.normal_(0.0, p[0].numel() ** -0.5, generator=generator)
        elif id(p) in gains:
            p.normal_(1.0, 0.1, generator=generator)
        else:
            p.normal_(0.0, 0.02, generator=generator)


class Dense(nn.Linear):
    """nn.Linear that computes in `compute_dtype`."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias, dtype=dtype)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(cd)
        return F.linear(x.to(cd), self.weight.to(cd), bias)


class LayerNorm(nn.Module):
    """LayerNorm with fp32 statistics, output in the input dtype.
    `fused=True` routes rows of a width that is a multiple of 128 through
    kernel B6 (`ops.layernorm.fused_layernorm`); other widths take the plain
    math, as the JAX dispatch decides by shape (`ops/layernorm.py:62`)."""

    def __init__(self, dim: int, eps: float = 1e-5, fused: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps, self.fused = eps, fused
        self.weight = nn.Parameter(torch.ones(dim, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fn = fused_layernorm if self.fused and x.shape[-1] % 128 == 0 else layernorm_plain
        return fn(x, self.weight, self.bias, self.eps)


class HeadLayerNorm(nn.Module):
    """LayerNorm over the dh-wide head segments of a flat [..., H*dh]
    tensor with the affine shared across heads (the per-head QK norms;
    `ops.layernorm.head_layernorm`, kernel B10 on the card).  Params as a
    [dh] `LayerNorm`'s, so the converter maps the flax tree unchanged."""

    def __init__(self, head_dim: int, eps: float = 1e-6, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(head_dim, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(head_dim, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return head_layernorm(x, self.weight, self.bias, self.eps)


class LayerNormZero(nn.Module):
    """CogVideoXLayerNormZero: adaLN giving (video, text) shift/scale/gate.
    Returns (norm_video, norm_text, gate_video, gate_text)."""

    def __init__(self, time_embed_dim: int, dim: int, eps: float = 1e-5,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.linear = Dense(time_embed_dim, 6 * dim, compute_dtype=compute_dtype, dtype=dtype)
        self.norm = LayerNorm(dim, eps=eps, dtype=dtype)

    def forward(self, hidden, encoder_hidden, temb):
        mod = self.linear(F.silu(temb))
        shift, scale, gate, e_shift, e_scale, e_gate = mod.chunk(6, dim=-1)
        h = self.norm(hidden) * (1 + scale[:, None]) + shift[:, None]
        e = self.norm(encoder_hidden) * (1 + e_scale[:, None]) + e_shift[:, None]
        cd = self.compute_dtype
        return h.to(cd), e.to(cd), gate[:, None], e_gate[:, None]


class AdaLayerNorm(nn.Module):
    """Final adaLN (diffusers AdaLayerNorm, chunk_dim=1: shift then scale)."""

    def __init__(self, time_embed_dim: int, dim: int, eps: float = 1e-5,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.linear = Dense(time_embed_dim, 2 * dim, compute_dtype=compute_dtype, dtype=dtype)
        self.norm = LayerNorm(dim, eps=eps, dtype=dtype)

    def forward(self, x, temb):
        shift, scale = self.linear(F.silu(temb)).chunk(2, dim=-1)
        y = self.norm(x)
        return (y * (1 + scale[:, None]) + shift[:, None]).to(self.compute_dtype)


class TimestepEmbedding(nn.Module):
    """Linear-SiLU-Linear over sinusoidal features."""

    def __init__(self, in_dim: int, time_embed_dim: int,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.linear_1 = Dense(in_dim, time_embed_dim, compute_dtype=compute_dtype, dtype=dtype)
        self.linear_2 = Dense(time_embed_dim, time_embed_dim, compute_dtype=compute_dtype,
                              dtype=dtype)

    def forward(self, t_freq):
        return self.linear_2(F.silu(self.linear_1(t_freq)))


class FeedForward(nn.Module):
    """gelu(tanh) MLP with biases (diffusers FeedForward)."""

    def __init__(self, dim: int, mult: int = 4,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.net_0 = Dense(dim, dim * mult, compute_dtype=compute_dtype, dtype=dtype)
        self.net_2 = Dense(dim * mult, dim, compute_dtype=compute_dtype, dtype=dtype)

    def forward(self, x):
        return self.net_2(F.gelu(self.net_0(x), approximate="tanh"))


class JointSelfAttention(nn.Module):
    """CogVideoX joint text+video self-attention over flat [B, S, H*D]
    q/k/v (JAX `layers.py:264-381`), with LoRA on to_q/to_k when
    `lora_rank > 0`: base + (x A) B * alpha/r, A [dim, r] and B [r, inner]
    named `to_q_lora_A`/`to_q_lora_B` as the flax leaves.

    Two paths, as the JAX module decides by `fuse_qk_norm`:
      * inference (`fuse_qk_norm=True`): the per-head QK LayerNorm (eps
        1e-6) and the video-only RoPE run inside kernel B1 (no backward);
      * training: `norm_q`/`norm_k` (kernel B10) on the projections, then
        the differentiable attention with RoPE from row `text_len` inside
        it: kernel B7 on the flat projections when the heads pack into
        128 lanes (`heads % max(1, 128 // head_dim) == 0`, JAX
        `layers.py:354-367`), else kernels B11 and B12 + B13 on the [B, S, H, D]
        view of them (`attention(layout="bshd")`, JAX `layers.py:368-373`)."""

    def __init__(self, dim: int, heads: int, head_dim: int, qk_norm: bool = True,
                 bias: bool = True, out_bias: bool = True, lora_rank: int = 0,
                 lora_alpha: float = 128.0, fuse_qk_norm: bool = False,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads, self.head_dim, self.fuse_qk_norm = heads, head_dim, fuse_qk_norm
        self.compute_dtype = compute_dtype
        inner = heads * head_dim
        kw = dict(compute_dtype=compute_dtype, dtype=dtype)
        self.to_q = Dense(dim, inner, bias=bias, **kw)
        self.to_k = Dense(dim, inner, bias=bias, **kw)
        self.to_v = Dense(dim, inner, bias=bias, **kw)
        self.norm_q = HeadLayerNorm(head_dim, eps=1e-6, dtype=dtype) if qk_norm else None
        self.norm_k = HeadLayerNorm(head_dim, eps=1e-6, dtype=dtype) if qk_norm else None
        self.to_out = Dense(inner, dim, bias=out_bias, **kw)
        self.lora_scaling = lora_alpha / lora_rank if lora_rank > 0 else 0.0
        if lora_rank > 0:
            for name in ("to_q", "to_k"):
                self.register_parameter(f"{name}_lora_A", nn.Parameter(
                    torch.zeros(dim, lora_rank, dtype=dtype)))
                self.register_parameter(f"{name}_lora_B", nn.Parameter(
                    torch.zeros(lora_rank, inner, dtype=dtype)))

    def _proj(self, name: str, x: torch.Tensor) -> torch.Tensor:
        out = getattr(self, name)(x)
        if self.lora_scaling:
            cd = self.compute_dtype
            a, b = getattr(self, f"{name}_lora_A"), getattr(self, f"{name}_lora_B")
            out = out + (x.to(cd) @ a.to(cd)) @ b.to(cd) * self.lora_scaling
        return out

    def forward(self, hidden, encoder_hidden,
                rope: Optional[Tuple[torch.Tensor, torch.Tensor]]):
        text_len = encoder_hidden.shape[1]
        x = torch.cat([encoder_hidden, hidden], dim=1)
        q, k, v = self._proj("to_q", x), self._proj("to_k", x), self.to_v(x)
        if self.fuse_qk_norm:
            qk_norm = None
            if self.norm_q is not None:
                qk_norm = (self.norm_q.weight, self.norm_q.bias,
                           self.norm_k.weight, self.norm_k.bias)
            o = attention(q, k, v, rope=rope, rope_start=text_len, layout="flat",
                          qk_norm=qk_norm, heads=self.heads)
        else:
            if self.norm_q is not None:
                q, k = self.norm_q(q), self.norm_k(k)
            if self.heads % max(1, 128 // self.head_dim) == 0:
                o = flash_attention_flat(q, k, v, self.heads, rope=rope, rope_start=text_len)
            else:
                b, s, inner = q.shape
                bshd = lambda t: t.reshape(b, s, self.heads, self.head_dim)   # a free view
                o = attention(bshd(q), bshd(k), bshd(v), rope=rope, rope_start=text_len,
                              layout="bshd").reshape(b, s, inner)
        o = self.to_out(o)
        return o[:, text_len:], o[:, :text_len]


class CogVideoXBlock(nn.Module):
    """One DiT block (reference `models/transformer.py:143-262`)."""

    def __init__(self, dim: int, heads: int, head_dim: int, time_embed_dim: int,
                 eps: float = 1e-5, ff_mult: int = 4, qk_norm: bool = True,
                 attention_bias: bool = True, lora_rank: int = 0, lora_alpha: float = 128.0,
                 fuse_qk_norm: bool = False,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        kw = dict(compute_dtype=compute_dtype, dtype=dtype)
        self.norm1 = LayerNormZero(time_embed_dim, dim, eps=eps, **kw)
        self.attn1 = JointSelfAttention(dim, heads, head_dim, qk_norm=qk_norm,
                                        bias=attention_bias, lora_rank=lora_rank,
                                        lora_alpha=lora_alpha, fuse_qk_norm=fuse_qk_norm, **kw)
        self.norm2 = LayerNormZero(time_embed_dim, dim, eps=eps, **kw)
        self.ff = FeedForward(dim, mult=ff_mult, **kw)

    def forward(self, hidden, encoder_hidden, temb, rope):
        text_len = encoder_hidden.shape[1]
        nh, ne, gate, e_gate = self.norm1(hidden, encoder_hidden, temb)
        attn_h, attn_e = self.attn1(nh, ne, rope)
        hidden = hidden + (gate * attn_h).to(hidden.dtype)
        encoder_hidden = encoder_hidden + (e_gate * attn_e).to(hidden.dtype)
        nh, ne, gate_ff, e_gate_ff = self.norm2(hidden, encoder_hidden, temb)
        ff_out = self.ff(torch.cat([ne, nh], dim=1))
        hidden = hidden + (gate_ff * ff_out[:, text_len:]).to(hidden.dtype)
        encoder_hidden = encoder_hidden + (e_gate_ff * ff_out[:, :text_len]).to(hidden.dtype)
        return hidden, encoder_hidden


class PatchEmbed(nn.Module):
    """Text projection + patchified-latent projection, concatenated
    (the 2x2 patch conv as one matmul over `ops.patch.patchify` tokens)."""

    def __init__(self, text_dim: int, patch_dim: int, dim: int,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.text_proj = Dense(text_dim, dim, compute_dtype=compute_dtype, dtype=dtype)
        self.proj = Dense(patch_dim, dim, compute_dtype=compute_dtype, dtype=dtype)

    def forward(self, text_embeds, patch_tokens):
        return torch.cat([self.text_proj(text_embeds), self.proj(patch_tokens)], dim=1)

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
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import attention
from ..ops.ff import ff_chunked
from ..ops.flash_attention import flash_attention, flash_attention_flat, flat_heads_pack
from ..ops.layernorm import fused_layernorm, head_layernorm, layernorm_plain
from ..ops.ring_attention import ring_attention
from ..ops.rope import apply_rotary_emb

# The tag of the joint attention's differentiable forward (the JAX
# `checkpoint_name(o, "attn_out")`), whose outputs remat_policy="save_attn"
# keeps across the group recompute (`models/dit.py`)
ATTN_OUT = "attn_out"


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
    """gelu(tanh) MLP with biases (diffusers FeedForward).  `chunks > 1`
    runs it through `ops.ff.ff_chunked` (S-chunks, a recompute backward),
    the same parameters, so checkpoints are interchangeable."""

    def __init__(self, dim: int, mult: int = 4, chunks: int = 1,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.chunks = chunks
        self.net_0 = Dense(dim, dim * mult, compute_dtype=compute_dtype, dtype=dtype)
        self.net_2 = Dense(dim * mult, dim, compute_dtype=compute_dtype, dtype=dtype)

    def forward(self, x):
        if self.chunks > 1:
            return ff_chunked(x.to(self.net_0.compute_dtype), self.net_0.weight,
                              self.net_0.bias, self.net_2.weight, self.net_2.bias, self.chunks)
        return self.net_2(F.gelu(self.net_0(x), approximate="tanh"))


class JointSelfAttention(nn.Module):
    """CogVideoX joint text+video self-attention over flat [B, S, H*D]
    q/k/v (JAX `layers.py:264-381`), with LoRA on to_q/to_k when
    `lora_rank > 0`: base + (x A) B * alpha/r, A [dim, r] and B [r, inner]
    named `to_q_lora_A`/`to_q_lora_B` as the flax leaves.

    Two paths, as the JAX module decides by `fuse_qk_norm`:
      * inference (`fuse_qk_norm=True`) at head dims 32, 64 and 128 (JAX
        `layers.py:276-278`) with heads that pack into 128 lanes: the
        per-head QK LayerNorm (eps 1e-6) and the video-only RoPE run inside
        kernel B1 (no backward); at other head dims the training path's
        kernels, as JAX's module takes its other path;
      * training: `norm_q`/`norm_k` (kernel B10) on the projections, then
        the differentiable attention with RoPE from row `text_len` inside
        it: kernel B7 on the flat projections when the heads pack into
        128 lanes (`heads % max(1, 128 // head_dim) == 0`, JAX
        `layers.py:354-367`), else kernels B11 and B12 + B13 on the [B, S, H, D]
        view of them (`attention(layout="bshd")`, JAX `layers.py:368-373`;
        below 1,024 rows `sdpa`, as JAX's dispatch rule decides).  The kernels'
        forward is tagged `ATTN_OUT` for remat_policy="save_attn".

    With an `sp_group` (sequence parallelism, inference only, JAX
    `layers.py:249-253, 334-352`) the joint sequence is padded to a multiple
    of `sp * 128`, each rank projects its own rows, applies `norm_q`/`norm_k`
    and the RoPE of its rows outside the attention, runs the ring
    (`ops.ring_attention`, kernel B7's forward per block) and all-gathers
    the output rows, so the rest of the block runs replicated.  Under
    tensor parallelism (`parallel.tp`) `heads` is this rank's share."""

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

    def _sp_attention(self, x: torch.Tensor, text_len: int, rope, group) -> torch.Tensor:
        """The ring path: this rank's rows of the padded joint sequence
        through the projections, the QK norms, RoPE and the ring; the
        gathered output [B, S, H*D] (the padding sliced away)."""
        n, me = dist.get_world_size(group), dist.get_rank(group)
        b, s_real, _ = x.shape
        s_pad = -(-s_real // (n * 128)) * n * 128
        rows = s_pad // n
        lo = me * rows
        x = F.pad(x, (0, 0, 0, s_pad - s_real))[:, lo:lo + rows]
        q, k, v = self._proj("to_q", x), self._proj("to_k", x), self.to_v(x)
        if self.norm_q is not None:
            q, k = self.norm_q(q), self.norm_k(k)
        if rope is not None:
            # rows [text_len, text_len + R) of the whole sequence take RoPE:
            # rotate the ones that fall in this shard
            cos, sin = rope
            a, e = max(lo, text_len), min(lo + rows, text_len + cos.shape[0])
            if a < e:
                view = lambda t: t.reshape(b, rows, self.heads, self.head_dim).transpose(1, 2)
                rot = lambda t: torch.cat([
                    t[:, :a - lo], apply_rotary_emb(
                        view(t)[:, :, a - lo:e - lo], cos[a - text_len:e - text_len],
                        sin[a - text_len:e - text_len]).transpose(1, 2).reshape(b, e - a, -1),
                    t[:, e - lo:]], dim=1)
                q, k = rot(q), rot(k)
        o = ring_attention(q.contiguous(), k.contiguous(), v.contiguous(), self.heads, group,
                           self.head_dim ** -0.5, valid_len=s_real)
        parts = [torch.empty_like(o) for _ in range(n)]
        dist.all_gather(parts, o.contiguous(), group=group)
        return torch.cat(parts, dim=1)[:, :s_real]

    def forward(self, hidden, encoder_hidden,
                rope: Optional[Tuple[torch.Tensor, torch.Tensor]], sp_group=None):
        text_len = encoder_hidden.shape[1]
        x = torch.cat([encoder_hidden, hidden], dim=1)
        if sp_group is not None:
            o = self.to_out(self._sp_attention(x, text_len, rope, sp_group))
            return o[:, text_len:], o[:, :text_len]
        q, k, v = self._proj("to_q", x), self._proj("to_k", x), self.to_v(x)
        if (self.fuse_qk_norm and self.head_dim in (32, 64, 128)
                and flat_heads_pack(self.head_dim, self.heads)):
            qk_norm = None
            if self.norm_q is not None:
                qk_norm = (self.norm_q.weight, self.norm_q.bias,
                           self.norm_k.weight, self.norm_k.bias)
            # the fused flat form (B1) at JAX's head dims (`layers.py:276-278`)
            # and at every length: JAX pads the sequence to 2,048 rows and
            # takes it from 1,024 on, below that its XLA path computes the
            # same function.  Heads that do not pack into 128 lanes (15 x 64,
            # 6 x 32) would meet the assert of JAX's flat kernel; the port
            # takes the unfused path below, which computes the same function
            o = flash_attention(q, k, v, self.heads, rope=rope, rope_start=text_len,
                                qk_norm=qk_norm, layout="flat")
        else:
            # the QK norms (B10), then B7's flat kernels where the heads pair
            # in 128 lanes (JAX's rule: 48-wide heads pass it and then meet
            # the flat kernels' packing check, as in JAX), else B11 and
            # B12 + B13 on the bshd view
            if self.norm_q is not None:
                q, k = self.norm_q(q), self.norm_k(k)
            if self.heads % max(1, 128 // self.head_dim) == 0:
                o = flash_attention_flat(q, k, v, self.heads, rope=rope, rope_start=text_len,
                                         name=ATTN_OUT)
            else:
                b, s, inner = q.shape
                bshd = lambda t: t.reshape(b, s, self.heads, self.head_dim)   # a free view
                o = attention(bshd(q), bshd(k), bshd(v), rope=rope, rope_start=text_len,
                              layout="bshd", name=ATTN_OUT).reshape(b, s, inner)
        o = self.to_out(o)
        return o[:, text_len:], o[:, :text_len]


class CogVideoXBlock(nn.Module):
    """One DiT block (reference `models/transformer.py:143-262`)."""

    def __init__(self, dim: int, heads: int, head_dim: int, time_embed_dim: int,
                 eps: float = 1e-5, ff_mult: int = 4, qk_norm: bool = True,
                 attention_bias: bool = True, lora_rank: int = 0, lora_alpha: float = 128.0,
                 fuse_qk_norm: bool = False, ff_chunks: int = 1,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        kw = dict(compute_dtype=compute_dtype, dtype=dtype)
        self.norm1 = LayerNormZero(time_embed_dim, dim, eps=eps, **kw)
        self.attn1 = JointSelfAttention(dim, heads, head_dim, qk_norm=qk_norm,
                                        bias=attention_bias, lora_rank=lora_rank,
                                        lora_alpha=lora_alpha, fuse_qk_norm=fuse_qk_norm, **kw)
        self.norm2 = LayerNormZero(time_embed_dim, dim, eps=eps, **kw)
        self.ff = FeedForward(dim, mult=ff_mult, chunks=ff_chunks, **kw)

    def forward(self, hidden, encoder_hidden, temb, rope, sp_group=None):
        text_len = encoder_hidden.shape[1]
        nh, ne, gate, e_gate = self.norm1(hidden, encoder_hidden, temb)
        attn_h, attn_e = self.attn1(nh, ne, rope, sp_group)
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

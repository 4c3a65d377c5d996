"""Audio conditioning in torch (port of `bindyouravatar_tpu/models/audio.py`).

  * `sliding_windows`: [.., 4F+1+4, 12, 768] -> [.., 4F+1, 5, 12, 768]
  * `AudioProjModel`: window MLP -> 32 context tokens, then the pair-strided
    Conv1d (as one matmul) twice with the odd-first-frame passthrough
    (49 -> 25 -> 13 latent frames), then a LayerNorm through kernel B6
  * `AudioCrossAttnLayer`: per-DiT-layer frame-local cross-attention, routing
    weights fused into kernel B3, out-projection with the sum(w)-scaled bias
  * `AudioStatics`: the projection plus the mute track for one-track clips
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import AudioConfig
from ..ops.short_kv_attention import short_kv_attention_combined_flat
from .layers import Dense, LayerNorm


def sliding_windows(audio_embeds: torch.Tensor, num_pixel_frames: int,
                    window_size: int = 5, window_stride: int = 1) -> torch.Tensor:
    """[..., A, blocks, C] -> [..., num_pixel_frames, window, blocks, C];
    A must equal num_pixel_frames + window_size - window_stride."""
    a = audio_embeds.shape[-3]
    if a != num_pixel_frames + (window_size - window_stride):
        raise ValueError(f"audio frames {a} != pixel frames {num_pixel_frames} "
                         f"+ window slack {window_size - window_stride}")
    slices = [audio_embeds[..., i:i + num_pixel_frames, :, :] for i in range(window_size)]
    return torch.stack(slices, dim=-3)


class AudioProjModel(nn.Module):
    """windows [B, F, W, blocks, C] -> [B, F_latent, ctx_tokens, audio_dim]."""

    def __init__(self, cfg: AudioConfig, compute_dtype: torch.dtype = torch.bfloat16,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg, self.compute_dtype = cfg, compute_dtype
        kw = dict(compute_dtype=compute_dtype, dtype=dtype)
        in_dim = cfg.window_size * cfg.blocks * cfg.audio_dim
        ctx_dim = cfg.context_tokens * cfg.audio_dim
        self.proj1 = Dense(in_dim, cfg.intermediate_dim, **kw)
        self.proj2 = Dense(cfg.intermediate_dim, cfg.intermediate_dim, **kw)
        self.proj3 = Dense(cfg.intermediate_dim, ctx_dim, **kw)
        # Conv1d(k=2, s=2) over frame pairs (flax `conv_w` [2C, C], `conv_b`)
        self.conv = Dense(2 * ctx_dim, ctx_dim, **kw)
        self.norm = LayerNorm(cfg.audio_dim, fused=True, dtype=dtype)

    def _downsample(self, t: torch.Tensor) -> torch.Tensor:
        b, n, c = t.shape
        if n % 2 == 1:
            pairs = t[:, 1:].reshape(b, (n - 1) // 2, 2 * c)
            return torch.cat([t[:, :1], self.conv(pairs)], dim=1)
        return self.conv(t.reshape(b, n // 2, 2 * c))

    def forward(self, windows: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        b, f = windows.shape[0], windows.shape[1]
        x = windows.reshape(b, f, -1).to(self.compute_dtype)
        x = F.relu(self.proj1(x))
        x = F.relu(self.proj2(x))
        x = self.proj3(x)
        x = self._downsample(self._downsample(x))
        x = x.reshape(b, x.shape[1], c.context_tokens, c.audio_dim)
        return self.norm(x)


class EinsumOutProj(nn.Module):
    """to_out with a per-query-scaled bias: y = o W^T + bias_scale * b
    (the identity-combined path's bias is sum_i(w_i) * bias).  Split
    row-wise under tensor parallelism (`parallel.tp`): `weight` holds this
    rank's input columns and `tp_group` sums the partial products before
    the bias."""

    def __init__(self, in_dim: int, out_dim: int, compute_dtype: torch.dtype = torch.bfloat16,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(out_dim, dtype=dtype))
        self.tp_group = None

    def forward(self, o: torch.Tensor, bias_scale: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        y = F.linear(o.to(cd), self.weight.to(cd))
        if self.tp_group is not None:
            torch.distributed.all_reduce(y, group=self.tp_group)
        return y + bias_scale[..., None] * self.bias.to(cd)


class AudioCrossAttnLayer(nn.Module):
    """One per-DiT-layer audio cross-attention (frame-local), routing path:
    video [B, S, D] (S = F*HW), audio ctx [B, I, F, n_ctx, A], weights
    [B, S, I] -> the injection [B, S, D].  `heads` is this rank's share
    under tensor parallelism (`parallel.tp`)."""

    def __init__(self, cfg: AudioConfig, compute_dtype: torch.dtype = torch.bfloat16,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg, self.compute_dtype = cfg, compute_dtype
        self.heads = cfg.num_attention_heads
        inner = cfg.num_attention_heads * cfg.attention_head_dim
        kw = dict(compute_dtype=compute_dtype, dtype=dtype)
        self.norm_q = LayerNorm(cfg.dim, fused=True, dtype=dtype)
        self.to_q = Dense(cfg.dim, inner, **kw)
        self.to_k = Dense(cfg.audio_dim, inner, **kw)
        self.to_v = Dense(cfg.audio_dim, inner, **kw)
        self.to_out = EinsumOutProj(inner, cfg.dim, **kw)

    def forward(self, video: torch.Tensor, audio_ctx: torch.Tensor,
                weights: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        b, s, _ = video.shape
        n_id, f, n_ctx = audio_ctx.shape[1], audio_ctx.shape[2], audio_ctx.shape[3]
        hw = s // f
        nh, dh = self.heads, c.attention_head_dim
        q = self.to_q(self.norm_q(video))
        k = self.to_k(audio_ctx)
        v = self.to_v(audio_ctx)
        per_frame = lambda t: (t.reshape(b, n_id, f, n_ctx, nh, dh)
                               .permute(0, 2, 1, 4, 3, 5)
                               .reshape(b * f, n_id, nh, n_ctx, dh).contiguous())
        wk = weights.to(self.compute_dtype).reshape(b * f, hw, n_id).contiguous()
        o = short_kv_attention_combined_flat(q.reshape(b * f, hw, nh * dh), per_frame(k),
                                             per_frame(v), wk, dh ** -0.5)
        return self.to_out(o.reshape(b, s, nh * dh), wk.sum(-1).reshape(b, s))


def mute_dropout_keep(cfg: AudioConfig, device: torch.device,
                      generator: Optional[torch.Generator]) -> torch.Tensor:
    """The mute tokens' dropout keep mask (keep probability 0.9), bool
    [1, ctx_tokens, audio_dim], drawn from `generator`."""
    u = torch.rand((1, cfg.context_tokens, cfg.audio_dim), generator=generator, device=device)
    return u < 0.9


class AudioStatics(nn.Module):
    """Non-layer audio params: the projection, the mute tokens and the
    (unused in the forward, kept for checkpoint parity) learnable_scale."""

    def __init__(self, cfg: AudioConfig, compute_dtype: torch.dtype = torch.bfloat16,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.proj = AudioProjModel(cfg, compute_dtype=compute_dtype, dtype=dtype)
        self.mute_learnable_tokens = nn.Parameter(
            torch.zeros(1, cfg.context_tokens, cfg.audio_dim, dtype=dtype))
        self.learnable_scale = nn.Parameter(torch.full((1,), 0.01, dtype=dtype))

    def forward(self, audio_embeds: torch.Tensor, num_pixel_frames: int,
                mute_embeds: Optional[torch.Tensor] = None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                dropout_keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[B, n_tracks, A, blocks, C] -> ctx [B, I, F_lat, ctx_tokens, audio_dim].
        With one track, the second identity's track is the mute fixture
        projected the same way plus the learnable tokens; with
        `deterministic=False` the tokens go through dropout p = 0.1 (JAX
        `audio.py:238-241`): kept where `dropout_keep` (bool [1, ctx_tokens,
        audio_dim]) is set, which is drawn from `generator` when not given."""
        c = self.cfg
        b, n_tracks = audio_embeds.shape[0], audio_embeds.shape[1]
        flat = audio_embeds.reshape((b * n_tracks,) + tuple(audio_embeds.shape[2:]))
        wins = sliding_windows(flat, num_pixel_frames, c.window_size, c.window_stride)
        ctx = self.proj(wins)
        ctx = ctx.reshape((b, n_tracks) + tuple(ctx.shape[1:]))
        if n_tracks == 1:
            if mute_embeds is None:
                raise ValueError("single-track audio requires mute_embeds fixture")
            mw = sliding_windows(mute_embeds[None], num_pixel_frames,
                                 c.window_size, c.window_stride)
            tok = self.mute_learnable_tokens.to(ctx.dtype)
            if not deterministic:
                if dropout_keep is None:
                    dropout_keep = mute_dropout_keep(self.cfg, ctx.device, generator)
                tok = torch.where(dropout_keep, tok / 0.9, torch.zeros_like(tok))
            mute_ctx = self.proj(mw) + tok[None]
            ctx = torch.cat([ctx, mute_ctx[None].expand_as(ctx).to(ctx.dtype)], dim=1)
        return ctx

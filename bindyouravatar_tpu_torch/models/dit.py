"""BindYourAvatar DiT denoiser in torch (port of `bindyouravatar_tpu/models/dit.py`).

The JAX package scans over layer groups with `[L, ...]`-stacked params; here
each layer is its own module (`blocks`, `audio_layers` ModuleLists) and the
scan is a Python loop.  This slice runs the bare and the audio-only
configurations (`is_train_face=False`): with no face path the routing is
the uniform 0.5 (JAX `dit.py:449-451`) and each audio layer is weighted by
its swap-and-inverted value (JAX `dit.py:430-437`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from ..config import AudioConfig, DiTConfig, tiny_dit_config
from ..ops.patch import patchify, unpatchify
from ..ops.rope import (get_3d_rotary_pos_embed, get_resize_crop_region_for_grid,
                        timestep_embedding)
from .audio import AudioCrossAttnLayer, AudioStatics
from .layers import (AdaLayerNorm, CogVideoXBlock, Dense, LayerNorm, PatchEmbed,
                     TimestepEmbedding, init_random_)


class DiT(nn.Module):
    """Denoiser with per-layer modules.  Build it with `create` (or `tiny`),
    then load a converted state dict or draw weights with `init_weights`."""

    def __init__(self, cfg: DiTConfig, audio_cfg: AudioConfig):
        super().__init__()
        if cfg.is_train_face:
            raise NotImplementedError(
                "the face path (perceiver, router, LFE; kernels B2, B4, B5) is not "
                "ported yet: ROADMAP queue A item 4")
        if not cfg.use_rotary_positional_embeddings:
            raise NotImplementedError("the 2B sincos position table is not ported")
        self.cfg, self.audio_cfg = cfg, audio_cfg
        kw = dict(compute_dtype=cfg.dtype, dtype=cfg.param_dtype)
        dim, p = cfg.inner_dim, cfg.patch_size
        self.patch_embed = PatchEmbed(cfg.text_embed_dim, cfg.in_channels * p * p, dim, **kw)
        self.time_embedding = TimestepEmbedding(dim, cfg.time_embed_dim, **kw)
        self.blocks = nn.ModuleList([
            CogVideoXBlock(dim, cfg.num_attention_heads, cfg.attention_head_dim,
                           cfg.time_embed_dim, eps=cfg.norm_eps, ff_mult=cfg.ff_mult,
                           qk_norm=cfg.qk_norm, attention_bias=cfg.attention_bias, **kw)
            for _ in range(cfg.num_layers)])
        self.norm_final = LayerNorm(dim, eps=cfg.norm_eps, dtype=cfg.param_dtype)
        self.norm_out = AdaLayerNorm(cfg.time_embed_dim, dim, eps=cfg.norm_eps, **kw)
        self.proj_out = Dense(dim, p * p * cfg.out_channels, **kw)
        if cfg.is_train_audio:
            self.audio_statics = AudioStatics(audio_cfg, **kw)
            self.audio_layers = nn.ModuleList(
                [AudioCrossAttnLayer(audio_cfg, **kw) for _ in range(audio_cfg.num_layers)])

    @classmethod
    def create(cls, cfg: DiTConfig, audio_cfg: Optional[AudioConfig] = None,
               device: torch.device | str = "cpu",
               generator: Optional[torch.Generator] = None) -> "DiT":
        """Build on `device` without touching the global RNG.  With a
        `generator` the weights are drawn from it (on the device); without
        one they are left uninitialised for `load_state_dict`."""
        if audio_cfg is None:
            audio_cfg = AudioConfig(
                dim=cfg.inner_dim, num_attention_heads=cfg.num_attention_heads,
                attention_head_dim=cfg.attention_head_dim,
                num_layers=cfg.num_layers // cfg.audio_attn_interval, norm_eps=cfg.norm_eps)
        with torch.device("meta"):
            model = cls(cfg, audio_cfg)
        model = model.to_empty(device=device)
        if generator is not None:
            model.init_weights(generator)
        return model

    @classmethod
    def tiny(cls, device: torch.device | str = "cpu",
             generator: Optional[torch.Generator] = None, **overrides) -> "DiT":
        """The JAX `DiT.tiny` shapes (the face path off by default here)."""
        overrides.setdefault("is_train_face", False)
        cfg = tiny_dit_config(**overrides)
        audio_cfg = AudioConfig(
            dim=cfg.inner_dim, audio_dim=16, blocks=2, intermediate_dim=16,
            context_tokens=4, num_attention_heads=cfg.num_attention_heads,
            attention_head_dim=cfg.attention_head_dim,
            num_layers=cfg.num_layers // cfg.audio_attn_interval)
        return cls.create(cfg, audio_cfg, device=device, generator=generator)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Random weights from `generator` (see `init_random_`); the
        learnable_scale keeps its constant 0.01."""
        init_random_(self, generator)
        if self.cfg.is_train_audio:
            self.audio_statics.learnable_scale.fill_(0.01)

    def rope(self, height_px: int, width_px: int, latent_frames: int,
             base_height_px: int = 480, base_width_px: int = 720, vae_spatial: int = 8,
             device: Optional[torch.device] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """3D RoPE tables (fp32 [T*H*W, head_dim]) for a pixel resolution."""
        c = self.cfg
        gh = height_px // (vae_spatial * c.patch_size)
        gw = width_px // (vae_spatial * c.patch_size)
        base_w = base_width_px // (vae_spatial * c.patch_size)
        base_h = base_height_px // (vae_spatial * c.patch_size)
        crops = get_resize_crop_region_for_grid((gh, gw), base_w, base_h)
        return get_3d_rotary_pos_embed(c.attention_head_dim, crops, (gh, gw), latent_frames,
                                       device=device)

    def prepare_conditioning(self, *, audio_embeds: Optional[torch.Tensor] = None,
                             mute_embeds: Optional[torch.Tensor] = None,
                             num_pixel_frames: Optional[int] = None):
        """(face_emb, audio_ctx [B, I, F, 32, 768]); face_emb is always None
        here.  Depends only on the conditioning inputs, so callers compute it
        once per clip and pass it to every `apply`."""
        c = self.cfg
        if not (c.is_train_audio and audio_embeds is not None):
            return None, None
        if num_pixel_frames is None:
            num_pixel_frames = c.sample_frames
        return None, self.audio_statics(audio_embeds.to(c.dtype), num_pixel_frames, mute_embeds)

    def apply(self, latents: torch.Tensor, text_embeds: torch.Tensor,
              timesteps: torch.Tensor, rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              *, audio_embeds: Optional[torch.Tensor] = None,
              mute_embeds: Optional[torch.Tensor] = None,
              af_matrix: Optional[torch.Tensor] = None,
              num_pixel_frames: Optional[int] = None,
              audio_ctx: Optional[torch.Tensor] = None):
        """One denoise step: latents [B, T, C_in, H, W], text [B, L, text_dim],
        timesteps [B] -> (output [B, T, C_out, H, W] fp32, routing_logits=None)."""
        c = self.cfg
        b, t, _, h_px, w_px = latents.shape
        grid = (t, h_px // c.patch_size, w_px // c.patch_size)
        s = grid[0] * grid[1] * grid[2]
        text_len = text_embeds.shape[1]
        if num_pixel_frames is None:
            num_pixel_frames = (t - 1) * c.temporal_compression_ratio + 1

        t_freq = timestep_embedding(timesteps, c.inner_dim, c.flip_sin_to_cos, c.freq_shift)
        temb = self.time_embedding(t_freq.to(c.dtype))
        x = self.patch_embed(text_embeds.to(c.dtype), patchify(latents, c.patch_size).to(c.dtype))
        enc, hid = x[:, :text_len], x[:, text_len:]

        if audio_ctx is None and c.is_train_audio and audio_embeds is not None:
            _, audio_ctx = self.prepare_conditioning(
                audio_embeds=audio_embeds, mute_embeds=mute_embeds,
                num_pixel_frames=num_pixel_frames)
        if audio_ctx is not None and af_matrix is None:
            af_matrix = torch.eye(c.num_ids, dtype=c.dtype, device=latents.device)[None].repeat(b, 1, 1)
        # uniform routing: no face path to predict it
        routing = torch.full((b, s, c.num_ids), 0.5, dtype=c.dtype, device=latents.device)

        for li, block in enumerate(self.blocks):
            hid, enc = block(hid, enc, temb, rope)
            if audio_ctx is not None and li % c.audio_attn_interval == 0:
                av = torch.einsum("bij,bsj->bsi", af_matrix.to(c.dtype), routing)
                inv = 1.0 - av.flip(-1)          # swap-and-invert
                hid = hid + self.audio_layers[li // c.audio_attn_interval](hid, audio_ctx, inv)

        joint = self.norm_final(torch.cat([enc, hid], dim=1))
        hid = self.norm_out(joint[:, text_len:], temb)
        hid = self.proj_out(hid)
        return unpatchify(hid, grid, c.out_channels, c.patch_size).float(), None

    forward = apply

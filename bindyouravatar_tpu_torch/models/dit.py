"""BindYourAvatar DiT denoiser in torch (port of `bindyouravatar_tpu/models/dit.py`).

The JAX package scans over layer groups with `[L, ...]`-stacked params; here
each layer is its own module (`blocks`, `audio_layers`, `perceivers`,
`router_layers` ModuleLists) and the scan is a Python loop over the same
groups (`cfg.group_size` layers, the injection schedule's period).  With
`cfg.remat` each group runs under `torch.utils.checkpoint` (non-reentrant),
blocks, face injection and audio layers together, as JAX's `group_body`;
`remat_policy="save_attn"` keeps the joint attention's forward outputs
(o and the LSE) across the group recompute (`keep_attention` on the calls
tagged `ATTN_OUT`), so that forward runs once per block; `"nested"`
checkpoints each block inside the group as well.  Inside a
layer the order is: block, then the face injection (every
`cross_attn_interval` layers), then audio.  The face injection runs the perceiver (kernel B2),
the router (shared norms, the layer's projections, the shared trunk) and
combines the identities' features with the routing before one `to_out`
(JAX `dit.py:400-424`); the audio layer is weighted by the swap-and-inverted
routing of the last face injection, or by the uniform 0.5 when no face
tokens are given (JAX `dit.py:430-437, 449-451`).
With `use_rotary_positional_embeddings=False` (the CogVideoX-2B variant) a
fixed 3D sincos `pos_embedding` is added after the patch embed, no
attention gets RoPE, and `norm_final` runs on the video tokens only.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import functools
import math

import numpy as np
import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..config import AudioConfig, DiTConfig, LFEConfig, RouterConfig, tiny_dit_config
from ..ops.flash_attention import keep_attention
from ..ops.patch import patchify, unpatchify
from ..ops.rope import (get_3d_rotary_pos_embed, get_3d_sincos_pos_embed,
                        get_resize_crop_region_for_grid, timestep_embedding)
from .audio import AudioCrossAttnLayer, AudioStatics
from .layers import (ATTN_OUT, AdaLayerNorm, CogVideoXBlock, Dense, LayerNorm, PatchEmbed,
                     TimestepEmbedding, init_random_)
from .lfe import LocalFacialExtractor
from .router import (MultiIPRouterLayerProj, MultiIPRouterTrunk, PerceiverCrossAttention,
                     RouterNorms, SelfAttention)


# the checkpointing policies the port implements (`DiTConfig.remat_policy`)
REMAT_POLICIES = (None, "save_attn", "nested")


class DiT(nn.Module):
    """Denoiser with per-layer modules.  Build it with `create` (or `tiny`),
    then load a converted state dict or draw weights with `init_weights`."""

    def __init__(self, cfg: DiTConfig, audio_cfg: AudioConfig, router_cfg: RouterConfig,
                 lfe_cfg: LFEConfig):
        super().__init__()
        if cfg.remat and cfg.remat_policy not in REMAT_POLICIES:
            raise NotImplementedError(
                f"remat_policy={cfg.remat_policy!r}: the port checkpoints with "
                f"{REMAT_POLICIES}")
        self.cfg, self.audio_cfg = cfg, audio_cfg
        self.router_cfg, self.lfe_cfg = router_cfg, lfe_cfg
        kw = dict(compute_dtype=cfg.dtype, dtype=cfg.param_dtype)
        dim, p = cfg.inner_dim, cfg.patch_size
        self.patch_embed = PatchEmbed(cfg.text_embed_dim, cfg.in_channels * p * p, dim, **kw)
        self.time_embedding = TimestepEmbedding(dim, cfg.time_embed_dim, **kw)
        self.blocks = nn.ModuleList([
            CogVideoXBlock(dim, cfg.num_attention_heads, cfg.attention_head_dim,
                           cfg.time_embed_dim, eps=cfg.norm_eps, ff_mult=cfg.ff_mult,
                           qk_norm=cfg.qk_norm, attention_bias=cfg.attention_bias,
                           lora_rank=cfg.lora_rank, lora_alpha=cfg.lora_alpha,
                           fuse_qk_norm=cfg.fuse_qk_norm, ff_chunks=cfg.ff_chunks, **kw)
            for _ in range(cfg.num_layers)])
        if not cfg.use_rotary_positional_embeddings:
            # the 2B variant: a fixed sincos table over the text rows (zero)
            # and the configured latent grid's rows (JAX `dit.py:186-192`)
            self.pos_embedding = nn.Parameter(torch.zeros(
                1, cfg.max_text_seq_length + cfg.video_seq_len, dim, dtype=cfg.param_dtype))
        self.norm_final = LayerNorm(dim, eps=cfg.norm_eps, dtype=cfg.param_dtype)
        self.norm_out = AdaLayerNorm(cfg.time_embed_dim, dim, eps=cfg.norm_eps, **kw)
        self.proj_out = Dense(dim, p * p * cfg.out_channels, **kw)
        if cfg.is_train_face:
            # contract: q_k_dim == perceiver heads * dim_head == LFE output
            # dim; the router's num_id_token == the LFE's num_queries
            dh = router_cfg.q_k_dim // router_cfg.num_heads
            self.lfe = LocalFacialExtractor(lfe_cfg, **kw)
            self.perceivers = nn.ModuleList([
                PerceiverCrossAttention(dim, dh, router_cfg.num_heads, cfg.lfe_final_output_dim,
                                        return_pre_out=True, **kw)
                for _ in range(cfg.num_ca)])
            self.router_norms = RouterNorms(router_cfg.q_k_dim, dtype=cfg.param_dtype)
            self.router_layers = nn.ModuleList([
                MultiIPRouterLayerProj(dh * router_cfg.num_heads, router_cfg.q_k_dim, **kw)
                for _ in range(cfg.num_ca)])
            self.router_trunk = MultiIPRouterTrunk(router_cfg, inference=cfg.fuse_qk_norm, **kw)
        if cfg.is_train_audio:
            self.audio_statics = AudioStatics(audio_cfg, **kw)
            self.audio_layers = nn.ModuleList(
                [AudioCrossAttnLayer(audio_cfg, **kw) for _ in range(audio_cfg.num_layers)])

    @classmethod
    def create(cls, cfg: DiTConfig, audio_cfg: Optional[AudioConfig] = None,
               router_cfg: Optional[RouterConfig] = None, lfe_cfg: Optional[LFEConfig] = None,
               device: torch.device | str = "cuda",
               generator: Optional[torch.Generator] = None) -> "DiT":
        """Build on `device` (the card unless the caller asks for another)
        without touching the global RNG.  With a `generator` the weights are
        drawn from it (on the device); without one they are left
        uninitialised for `load_state_dict`.  Sub-configs default as in the
        JAX `DiT.create`."""
        if audio_cfg is None:
            audio_cfg = AudioConfig(
                dim=cfg.inner_dim, num_attention_heads=cfg.num_attention_heads,
                attention_head_dim=cfg.attention_head_dim,
                num_layers=cfg.num_layers // cfg.audio_attn_interval, norm_eps=cfg.norm_eps)
        if router_cfg is None:
            router_cfg = RouterConfig(num_layers=cfg.num_ca, q_k_dim=cfg.lfe_final_output_dim,
                                      num_id_token=cfg.lfe_num_tokens)
        if lfe_cfg is None:
            lfe_cfg = LFEConfig(num_queries=cfg.lfe_num_tokens,
                                output_dim=cfg.lfe_final_output_dim)
        with torch.device("meta"):
            model = cls(cfg, audio_cfg, router_cfg, lfe_cfg)
        model = model.to_empty(device=device)
        if generator is not None:
            model.init_weights(generator)
        return model

    @classmethod
    def tiny(cls, device: torch.device | str = "cuda",
             generator: Optional[torch.Generator] = None, lfe: Optional[dict] = None,
             **overrides) -> "DiT":
        """The JAX `DiT.tiny` shapes and sub-configs (face path on unless
        `is_train_face=False` is passed); `lfe` overrides LFEConfig fields
        (the CLI's tiny tier sizes the LFE for its face stack)."""
        cfg = tiny_dit_config(**overrides)
        router_cfg = RouterConfig(
            num_layers=cfg.num_ca, q_k_dim=cfg.lfe_final_output_dim,
            num_id_token=cfg.lfe_num_tokens, num_heads=4, attn_heads=4,
            num_attention_layers=2)
        audio_cfg = AudioConfig(
            dim=cfg.inner_dim, audio_dim=16, blocks=2, intermediate_dim=16,
            context_tokens=4, num_attention_heads=cfg.num_attention_heads,
            attention_head_dim=cfg.attention_head_dim,
            num_layers=cfg.num_layers // cfg.audio_attn_interval)
        lfe_cfg = LFEConfig(
            dim=32, depth=5, dim_head=8, heads=4, num_id_token=2,
            num_queries=cfg.lfe_num_tokens, output_dim=cfg.lfe_final_output_dim,
            id_embed_dim=24, vit_dim=16)
        if lfe:
            lfe_cfg = dataclasses.replace(lfe_cfg, **lfe)
        return cls.create(cfg, audio_cfg, router_cfg, lfe_cfg, device=device,
                          generator=generator)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Random weights from `generator` (see `init_random_`); the
        learnable_scale keeps its constant 0.01 and the LFE's raw params
        take their JAX init."""
        init_random_(self, generator)
        if self.cfg.is_train_face:
            self.lfe.init_params_(generator)
        if self.cfg.is_train_audio:
            self.audio_statics.learnable_scale.fill_(0.01)
        if not self.cfg.use_rotary_positional_embeddings:
            self.pos_embedding.copy_(self.sincos_table())
        if self.cfg.lora_rank > 0:
            # peft's LoRA: A he-uniform over its fan-in, B zero (the update
            # starts at 0), as the flax initialisers
            for blk in self.blocks:
                for name in ("to_q", "to_k"):
                    a = getattr(blk.attn1, f"{name}_lora_A")
                    bound = math.sqrt(6.0 / a.shape[0])
                    a.uniform_(-bound, bound, generator=generator)
                    getattr(blk.attn1, f"{name}_lora_B").zero_()

    def sincos_table(self) -> torch.Tensor:
        """The 2B variant's `pos_embedding` value: [1, text + T*H*W, dim],
        zero on the text rows, the 3D sincos table of the configured latent
        grid (float64, cast once) on the video rows."""
        c = self.cfg
        t, hg, wg = c.latent_grid
        pos = get_3d_sincos_pos_embed(c.inner_dim, (hg, wg), t, c.spatial_interpolation_scale,
                                      c.temporal_interpolation_scale).reshape(-1, c.inner_dim)
        table = torch.zeros(1, c.max_text_seq_length + pos.shape[0], c.inner_dim,
                            dtype=torch.float32)
        table[0, c.max_text_seq_length:] = torch.from_numpy(pos.astype(np.float32))
        return table.to(device=self.pos_embedding.device, dtype=self.pos_embedding.dtype)

    def set_fuse_qk_norm(self, fuse: bool) -> None:
        """Switch between the inference path (`fuse=True`: QK-LN and RoPE
        inside kernel B1, bare B1 in the router, no backward) and the
        training path (B10, B7) in place; the parameters are the same."""
        self.cfg = dataclasses.replace(self.cfg, fuse_qk_norm=fuse)
        for blk in self.blocks:
            blk.attn1.fuse_qk_norm = fuse
        if self.cfg.is_train_face:
            for m in self.router_trunk.modules():
                if isinstance(m, SelfAttention):
                    m.inference = fuse

    def rope(self, height_px: int, width_px: int, latent_frames: int,
             base_height_px: int = 480, base_width_px: int = 720, vae_spatial: int = 8,
             device: Optional[torch.device] = None
             ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """3D RoPE tables (fp32 [T*H*W, head_dim]) for a pixel resolution;
        None for the 2B variant, which has no RoPE (the reference's
        CogVideoX-2B path; the JAX pipeline and trainer build the tables for
        it too and its attention would apply them)."""
        c = self.cfg
        if not c.use_rotary_positional_embeddings:
            return None
        gh = height_px // (vae_spatial * c.patch_size)
        gw = width_px // (vae_spatial * c.patch_size)
        base_w = base_width_px // (vae_spatial * c.patch_size)
        base_h = base_height_px // (vae_spatial * c.patch_size)
        crops = get_resize_crop_region_for_grid((gh, gw), base_w, base_h)
        return get_3d_rotary_pos_embed(c.attention_head_dim, crops, (gh, gw), latent_frames,
                                       device=device)

    def prepare_conditioning(self, *, id_cond: Optional[torch.Tensor] = None,
                             id_vit_hidden: Optional[torch.Tensor] = None,
                             audio_embeds: Optional[torch.Tensor] = None,
                             mute_embeds: Optional[torch.Tensor] = None,
                             num_pixel_frames: Optional[int] = None,
                             deterministic: bool = True,
                             generator: Optional[torch.Generator] = None,
                             dropout_keep: Optional[torch.Tensor] = None):
        """(face_emb [B, I, n_tok, q_k_dim], audio_ctx [B, I, F, 32, 768]),
        each None when its inputs are (id_cond [B, I, id_embed_dim],
        id_vit_hidden [B, I, scales, T, vit_dim]; audio as in `apply`).
        Depends only on the conditioning inputs, so callers compute it once
        per clip and pass it to every `apply`.  `deterministic=False` turns
        on the mute tokens' dropout (see `AudioStatics`)."""
        c = self.cfg
        face_emb = audio_ctx = None
        if c.is_train_face and id_cond is not None:
            b, n = id_cond.shape[0], id_cond.shape[0] * c.num_ids
            face = self.lfe(id_cond.reshape(n, -1).to(c.dtype),
                            id_vit_hidden.reshape((n,) + tuple(id_vit_hidden.shape[2:]))
                            .to(c.dtype))
            face_emb = face.reshape(b, c.num_ids, c.lfe_num_tokens, -1)
        if c.is_train_audio and audio_embeds is not None:
            if num_pixel_frames is None:
                num_pixel_frames = c.sample_frames
            audio_ctx = self.audio_statics(audio_embeds.to(c.dtype), num_pixel_frames,
                                           mute_embeds, deterministic, generator, dropout_keep)
        return face_emb, audio_ctx

    def _face_injection(self, pj: int, face_emb: torch.Tensor, hid: torch.Tensor,
                        grid: Tuple[int, int, int],
                        routing_override: Optional[torch.Tensor]):
        """Face layer `pj`: (new hid, routing prediction [B, S, I] fp32, the
        routing used, in the compute dtype)."""
        c = self.cfg
        perceiver = self.perceivers[pj]
        id_pre, q_flat, k_flat = perceiver(face_emb, hid)            # id_pre [B, I, S, H*dh]
        qp, kp = self.router_layers[pj](*self.router_norms(q_flat, k_flat))
        pred = self.router_trunk(qp, kp, grid)
        used = (pred if routing_override is None else routing_override).to(c.dtype)
        # routing combine before to_out (linear, so exact), then one projection
        pre = sum(used[..., i, None].float() * id_pre[:, i].float()
                  for i in range(id_pre.shape[1])).to(c.dtype)
        return hid + c.local_face_scale * perceiver.to_out(pre), pred, used

    def _group(self, gi: int, hid: torch.Tensor, enc: torch.Tensor, routing: torch.Tensor,
               temb: torch.Tensor, rope, grid: Tuple[int, int, int],
               face_emb: Optional[torch.Tensor], audio_ctx: Optional[torch.Tensor],
               af_matrix: Optional[torch.Tensor], routing_override: Optional[torch.Tensor],
               sp_group=None):
        """Layers [gi * g, (gi + 1) * g) (JAX `group_body`): each block, the
        face injection and the audio layer of the layers that have one.
        Returns (hid, enc, the routing used last, this group's predictions)."""
        c = self.cfg
        g = c.group_size
        nested = c.remat and c.remat_policy == "nested" and torch.is_grad_enabled()
        preds = []
        for li in range(gi * g, (gi + 1) * g):
            block = self.blocks[li]
            if nested:
                hid, enc = checkpoint(block, hid, enc, temb, rope, use_reentrant=False)
            else:
                hid, enc = block(hid, enc, temb, rope, sp_group)
            if face_emb is not None and li % c.cross_attn_interval == 0:
                hid, pred, routing = self._face_injection(li // c.cross_attn_interval, face_emb,
                                                          hid, grid, routing_override)
                preds.append(pred)
            if audio_ctx is not None and li % c.audio_attn_interval == 0:
                av = torch.einsum("bij,bsj->bsi", af_matrix.to(c.dtype), routing)
                inv = 1.0 - av.flip(-1)          # swap-and-invert
                hid = hid + self.audio_layers[li // c.audio_attn_interval](hid, audio_ctx, inv)
        return hid, enc, routing, preds

    def apply(self, latents: torch.Tensor, text_embeds: torch.Tensor,
              timesteps: torch.Tensor, rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              *, id_cond: Optional[torch.Tensor] = None,
              id_vit_hidden: Optional[torch.Tensor] = None,
              audio_embeds: Optional[torch.Tensor] = None,
              mute_embeds: Optional[torch.Tensor] = None,
              af_matrix: Optional[torch.Tensor] = None,
              routing_override: Optional[torch.Tensor] = None,
              num_pixel_frames: Optional[int] = None,
              face_emb: Optional[torch.Tensor] = None,
              audio_ctx: Optional[torch.Tensor] = None,
              deterministic: bool = True,
              generator: Optional[torch.Generator] = None,
              dropout_keep: Optional[torch.Tensor] = None,
              sp_group=None):
        """One denoise step: latents [B, T, C_in, H, W], text [B, L, text_dim],
        timesteps [B] -> (output [B, T, C_out, H, W] fp32, routing_logits
        [num_ca, B, S, I] fp32, or None when the face path did not run).
        `routing_override` [B, S, I] replaces the predicted routing in the
        face combine and the audio weights (the predictions are still
        returned).  `deterministic=False` (training) turns on the mute
        tokens' dropout, from `dropout_keep` or else drawn from `generator`.
        `sp_group` (a process group; inference only, as in JAX) runs every
        block's joint attention as ring attention over its ranks
        (`JointSelfAttention`); the rest of the step is replicated."""
        c = self.cfg
        if sp_group is not None and torch.is_grad_enabled():
            raise ValueError("sequence parallelism (sp_group) is inference only: call under "
                             "torch.no_grad()")
        b, t, _, h_px, w_px = latents.shape
        grid = (t, h_px // c.patch_size, w_px // c.patch_size)
        s = grid[0] * grid[1] * grid[2]
        text_len = text_embeds.shape[1]
        if num_pixel_frames is None:
            num_pixel_frames = (t - 1) * c.temporal_compression_ratio + 1

        t_freq = timestep_embedding(timesteps, c.inner_dim, c.flip_sin_to_cos, c.freq_shift)
        temb = self.time_embedding(t_freq.to(c.dtype))
        x = self.patch_embed(text_embeds.to(c.dtype), patchify(latents, c.patch_size).to(c.dtype))
        if not c.use_rotary_positional_embeddings:
            if rope is not None:
                raise ValueError("the 2B sincos DiT takes no RoPE tables (DiT.rope gives None)")
            x = x + self.pos_embedding[:, :text_len + s].to(x.dtype)
        enc, hid = x[:, :text_len], x[:, text_len:]

        if face_emb is None and c.is_train_face and id_cond is not None:
            face_emb, _ = self.prepare_conditioning(id_cond=id_cond, id_vit_hidden=id_vit_hidden)
        if audio_ctx is None and c.is_train_audio and audio_embeds is not None:
            _, audio_ctx = self.prepare_conditioning(
                audio_embeds=audio_embeds, mute_embeds=mute_embeds,
                num_pixel_frames=num_pixel_frames, deterministic=deterministic,
                generator=generator, dropout_keep=dropout_keep)
        if audio_ctx is not None and af_matrix is None:
            af_matrix = torch.eye(c.num_ids, dtype=c.dtype, device=latents.device)[None].repeat(b, 1, 1)
        if not c.is_train_face:
            face_emb = None
        # uniform routing until a face injection predicts one
        routing = torch.full((b, s, c.num_ids), 0.5, dtype=c.dtype, device=latents.device)
        preds = []
        remat = c.remat and torch.is_grad_enabled()
        for gi in range(c.num_layers // c.group_size):
            args = (gi, hid, enc, routing, temb, rope, grid, face_emb, audio_ctx, af_matrix,
                    routing_override, sp_group)
            if remat:
                kw = {}
                if c.remat_policy == "save_attn":
                    # JAX's save_only_these_names("attn_out"), the LSE kept
                    # too so the forward never reruns; the router's STAB
                    # attentions recompute, as in JAX
                    kw["context_fn"] = functools.partial(keep_attention, ATTN_OUT)
                hid, enc, routing, group_preds = checkpoint(self._group, *args,
                                                            use_reentrant=False, **kw)
            else:
                hid, enc, routing, group_preds = self._group(*args)
            preds += group_preds

        if c.use_rotary_positional_embeddings:
            hid = self.norm_final(torch.cat([enc, hid], dim=1))[:, text_len:]
        else:       # the 2B variant normalises the video rows only (JAX `dit.py:460-465`)
            hid = self.norm_final(hid)
        hid = self.norm_out(hid, temb)
        hid = self.proj_out(hid)
        out = unpatchify(hid, grid, c.out_channels, c.patch_size).float()
        return out, torch.stack(preds) if preds else None

    forward = apply

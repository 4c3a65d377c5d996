"""Configuration dataclasses of the port (torch dtypes, JAX defaults).

Mirrors `bindyouravatar_tpu/config.py` field for field for the configs the
serving and training paths need: the DiT's LoRA fields and its execution
knobs `fuse_qk_norm`, `remat` and `remat_policy` are here, as is
`TrainConfig`, and the conditioning encoders' `T5Config` (with
`from_dir`, the shapes of an HF T5 directory) and `EVACLIPConfig`; the 2B
position-table fields and the TPU-only knobs
(`use_flash_attention`, `ff_chunks`) are left out.  That module imports
`jax.numpy` for its dtype fields, so it is re-stated here rather than
imported.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    """CogVideoX-style DiT denoiser config (5B defaults)."""

    num_attention_heads: int = 48
    attention_head_dim: int = 64
    in_channels: int = 48          # 16 noise + 16 image + 16 bg-inpaint latents
    out_channels: int = 16
    time_embed_dim: int = 512
    text_embed_dim: int = 4096
    num_layers: int = 42
    attention_bias: bool = True
    sample_width: int = 90         # latent W
    sample_height: int = 60        # latent H
    sample_frames: int = 49        # pixel frames (13 latent frames)
    patch_size: int = 2
    temporal_compression_ratio: int = 4
    max_text_seq_length: int = 226
    norm_eps: float = 1e-5
    qk_norm: bool = True
    ff_mult: int = 4
    flip_sin_to_cos: bool = True
    freq_shift: int = 0
    use_rotary_positional_embeddings: bool = True

    # --- conditioning subsystems ---
    is_train_face: bool = True
    cross_attn_interval: int = 2        # 42 layers -> 21 face/router layers
    local_face_scale: float = 1.0
    lfe_num_tokens: int = 32
    is_train_audio: bool = True
    audio_attn_interval: int = 1
    num_ids: int = 2

    # --- LoRA on the joint self-attention's to_q/to_k ---
    lora_rank: int = 0
    lora_alpha: float = 128.0

    dtype: torch.dtype = torch.bfloat16        # activation/compute dtype
    param_dtype: torch.dtype = torch.float32
    # inference-configured (the pipeline sets it): the joint attention runs
    # the QK-LN and RoPE inside kernel B1 and the router's spatial attention
    # takes bare B1, neither with a backward; False is the training path
    # (QK-LN through B10, attention through B7)
    fuse_qk_norm: bool = False
    remat: bool = False                 # checkpoint each layer group
    # None: the group saves nothing; "save_attn": the joint attention's
    # outputs are kept across the group's recompute; "nested": each block
    # inside a group is checkpointed too, so the group's backward recomputes
    # one block at a time
    remat_policy: Optional[str] = None

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @property
    def num_ca(self) -> int:
        return self.num_layers // self.cross_attn_interval

    @property
    def lfe_final_output_dim(self) -> int:
        # reference `transformer.py:441`: int(inner_dim / 3 * 2)
        return int(self.inner_dim / 3 * 2)

    @property
    def group_size(self) -> int:
        """Layers per group: the period of the face/audio injection schedule."""
        g = 1
        if self.is_train_face:
            g = math.lcm(g, self.cross_attn_interval)
        if self.is_train_audio:
            g = math.lcm(g, self.audio_attn_interval)
        if self.num_layers % g:
            raise ValueError(f"num_layers={self.num_layers} not divisible by injection "
                             f"period {g}")
        return g

    @property
    def latent_frames(self) -> int:
        return (self.sample_frames - 1) // self.temporal_compression_ratio + 1

    @property
    def latent_grid(self) -> Tuple[int, int, int]:
        """Canonical (T, H, W) patch grid."""
        p = self.patch_size
        return (self.latent_frames, self.sample_height // p, self.sample_width // p)

    @property
    def video_seq_len(self) -> int:
        t, h, w = self.latent_grid
        return t * h * w


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """MultiIPRouter config (reference `models/router.py:280-332`); the
    (T, H, W) grid comes from the DiT's latent grid at call time."""
    num_id_token: int = 32
    num_heads: int = 16
    num_layers: int = 21
    q_k_dim: int = 2048
    num_attention_layers: int = 4
    attn_heads: int = 8
    mlp_ratio: int = 1

    @property
    def feat_dim(self) -> int:
        return self.num_id_token * self.num_heads  # 512


@dataclasses.dataclass(frozen=True)
class AudioConfig:
    """AudioAwareModel config (reference `models/audio_model.py:130-171`)."""
    dim: int = 3072
    audio_dim: int = 768
    num_attention_heads: int = 48
    attention_head_dim: int = 64
    window_size: int = 5
    window_stride: int = 1
    num_layers: int = 42
    blocks: int = 12
    intermediate_dim: int = 512
    context_tokens: int = 32
    norm_eps: float = 1e-5


@dataclasses.dataclass(frozen=True)
class LFEConfig:
    """LocalFacialExtractor config (reference `models/router.py:78-155`)."""
    dim: int = 1024
    depth: int = 10
    dim_head: int = 64
    heads: int = 16
    num_id_token: int = 5
    num_queries: int = 32
    output_dim: int = 2048
    ff_mult: int = 4
    id_embed_dim: int = 1280   # ArcFace 512 + CLIP pooled 768
    vit_dim: int = 1024
    num_scales: int = 5


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """Causal 3D VAE (CogVideoX `AutoencoderKLCogVideoX` semantics)."""
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 16
    block_out_channels: Tuple[int, ...] = (128, 256, 256, 512)
    layers_per_block: int = 3
    temporal_compression_ratio: int = 4
    spatial_compression_ratio: int = 8
    norm_num_groups: int = 32
    scaling_factor: float = 1.15258426
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32


@dataclasses.dataclass(frozen=True)
class T5Config:
    """T5-v1.1 encoder config; defaults = t5-xxl (the reference text encoder)."""
    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    @classmethod
    def from_dir(cls, path: str, **overrides) -> "T5Config":
        """The shapes of an HF T5 directory's `config.json` (t5-xxl's
        defaults where a field is missing)."""
        import json
        import os

        with open(os.path.join(path, "config.json")) as f:
            hf = json.load(f)
        fields = {f.name for f in dataclasses.fields(cls)} - {"dtype", "param_dtype"}
        return cls(**{k: hf[k] for k in fields if k in hf}, **overrides)


@dataclasses.dataclass(frozen=True)
class EVACLIPConfig:
    """EVA02-CLIP-L-14-336 visual tower (reference `models/eva_clip/`)."""
    image_size: int = 336
    patch_size: int = 14
    width: int = 1024
    depth: int = 24
    heads: int = 16
    mlp_ratio: float = 2.6667   # SwiGLU
    out_dim: int = 768          # pooled projection
    hidden_taps: Tuple[int, ...] = (4, 8, 12, 16, 20)
    use_rope: bool = True
    pt_hw_seq_len: int = 16
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size  # 24

    @property
    def seq_len(self) -> int:
        return self.grid * self.grid + 1  # 577


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """CogVideoX DDIM / DPM++ schedule (diffusers semantics)."""
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    snr_shift_scale: float = 3.0
    rescale_betas_zero_snr: bool = True
    prediction_type: str = "v_prediction"
    timestep_spacing: str = "trailing"
    set_alpha_to_one: bool = True


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    height: int = 480
    width: int = 720
    num_frames: int = 49
    num_inference_steps: int = 50
    guidance_scale: float = 6.0
    use_dynamic_cfg: bool = False
    scheduler_type: str = "dpm"         # "dpm" | "ddim"
    base_height: int = 480              # RoPE crop base
    base_width: int = 720
    zero2cond_cfg: bool = False
    # run the uncond/cond CFG halves as two sequential batch-B forwards
    # instead of one batch-2B forward: same FLOPs, half the activations
    cfg_microbatch: bool = False


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Stage-3 trainer config (the JAX `TrainConfig`, field for field)."""
    learning_rate: float = 1e-5
    optimizer: str = "adamw"
    use_8bit_adam: bool = False
    prodigy_beta3: Optional[float] = None
    prodigy_decouple: bool = True
    prodigy_use_bias_correction: bool = False
    prodigy_safeguard_warmup: bool = False
    is_diff_lr: bool = False
    diff_lr_high: float = 10.0
    diff_lr_low: float = 0.1
    lr_scheduler: str = "cosine_with_restarts"
    lr_warmup_steps: int = 100
    lr_num_cycles: int = 1
    max_train_steps: int = 10000
    weight_decay: float = 1e-4
    adam_beta1: float = 0.9
    adam_beta2: float = 0.95
    adam_epsilon: float = 1e-8
    max_grad_norm: float = 1.0
    grad_accum_steps: int = 2
    lora_rank: int = 128
    lora_alpha: int = 128
    router_loss_weight: float = 1.0
    consistency_loss_weight: float = 8.0
    temporal_diff_loss_weight: float = 0.002
    spatial_diff_loss_weight: float = 0.0009
    spatial_dist_loss_weight: float = 10.0
    id_dist_loss_weight: float = 10.0
    enable_mask_loss: bool = True
    mask_prob: float = 0.2
    noised_image_dropout: float = 0.05
    image_noise: bool = True
    image_noise_mean: float = -1.0
    image_noise_std: float = 0.5
    stochastic_vae: bool = True
    drop_inpaint_prob: float = 0.0
    index_mask_drop_prob: float = 0.2
    routing_logits_zeros_prob: float = 0.2
    compat_transposed_grid_losses: bool = True
    checkpointing_steps: int = 100
    checkpoints_total_limit: Optional[int] = None
    ema_decay: Optional[float] = None
    seed: int = 42


def tiny_dit_config(**overrides) -> DiTConfig:
    """A tiny DiT for fast tests: 2 groups of layers, 8x12 latent grid
    (the same shapes as the JAX package's `tiny_dit_config`)."""
    base = dict(
        num_attention_heads=6,   # inner 96: divisible by 3 (LFE dim contract)
        attention_head_dim=16,
        lfe_num_tokens=8,
        in_channels=8,
        out_channels=4,
        time_embed_dim=32,
        text_embed_dim=32,
        num_layers=4,
        sample_width=24,
        sample_height=16,
        sample_frames=9,
        max_text_seq_length=8,
        cross_attn_interval=2,
        audio_attn_interval=1,
        dtype=torch.float32,
    )
    base.update(overrides)
    return DiTConfig(**base)

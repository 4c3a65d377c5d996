"""3D rotary position embeddings, the 2B variant's 3D sincos table and
timestep features (torch).

Port of `bindyouravatar_tpu/ops/rope.py`: the same rotate-half convention
(pairs are (x_i, x_{i+d/2})), the same diffusers CogVideoX channel split, and
tables built in float64 numpy before the cast.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch


def get_resize_crop_region_for_grid(
    src: Tuple[int, int], tgt_width: int, tgt_height: int
) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """Aspect-fit center-crop region used to index the RoPE base grid.
    `src` is (grid_h, grid_w) of the latent grid, tgt_* the base grid."""
    h, w = src
    r = h / w
    if r > (tgt_height / tgt_width):
        resize_height = tgt_height
        resize_width = int(round(tgt_height / h * w))
    else:
        resize_width = tgt_width
        resize_height = int(round(tgt_width / w * h))
    crop_top = int(round((tgt_height - resize_height) / 2.0))
    crop_left = int(round((tgt_width - resize_width) / 2.0))
    return (crop_top, crop_left), (crop_top + resize_height, crop_left + resize_width)


def _1d_freqs(dim: int, pos: np.ndarray, theta: float = 10000.0) -> np.ndarray:
    inv_freq = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64)[: dim // 2] / dim))
    return np.outer(pos.astype(np.float64), inv_freq)


def get_3d_rotary_pos_embed(
    embed_dim: int,
    crops_coords: Tuple[Tuple[int, int], Tuple[int, int]],
    grid_size: Tuple[int, int],
    temporal_size: int,
    theta: float = 10000.0,
    dtype: torch.dtype = torch.float32,
    device: Optional[torch.device] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables, each [T*H*W, embed_dim], rotate-half layout
    (dim_t = d/4 on time, dim_h = dim_w = 3d/8 on space)."""
    (top, left), (bottom, right) = crops_coords
    grid_h, grid_w = grid_size
    dim_t = embed_dim // 4
    dim_h = embed_dim // 8 * 3
    dim_w = embed_dim // 8 * 3

    pos_t = np.arange(temporal_size, dtype=np.float64)
    pos_h = np.linspace(top, bottom, grid_h, endpoint=False, dtype=np.float64)
    pos_w = np.linspace(left, right, grid_w, endpoint=False, dtype=np.float64)

    ft = _1d_freqs(dim_t, pos_t, theta)
    fh = _1d_freqs(dim_h, pos_h, theta)
    fw = _1d_freqs(dim_w, pos_w, theta)

    shape = (temporal_size, grid_h, grid_w)
    t = np.broadcast_to(ft[:, None, None, :], shape + (ft.shape[-1],))
    h = np.broadcast_to(fh[None, :, None, :], shape + (fh.shape[-1],))
    w = np.broadcast_to(fw[None, None, :, :], shape + (fw.shape[-1],))
    freqs = np.concatenate([t, h, w], axis=-1).reshape(-1, embed_dim // 2)

    cos = np.concatenate([np.cos(freqs), np.cos(freqs)], axis=-1)
    sin = np.concatenate([np.sin(freqs), np.sin(freqs)], axis=-1)
    return (torch.from_numpy(cos).to(device=device, dtype=dtype),
            torch.from_numpy(sin).to(device=device, dtype=dtype))


def get_1d_sincos_pos_embed_np(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    """[P, embed_dim] transformer sincos table (sin || cos halves), float64."""
    omega = np.arange(embed_dim // 2, dtype=np.float64) / (embed_dim / 2.0)
    omega = 1.0 / 10000.0 ** omega
    out = np.einsum("p,d->pd", pos.astype(np.float64), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def get_3d_sincos_pos_embed(embed_dim: int, spatial_size: Tuple[int, int], temporal_size: int,
                            spatial_interpolation_scale: float = 1.875,
                            temporal_interpolation_scale: float = 1.0) -> np.ndarray:
    """[T, H*W, embed_dim] float64 3D sincos table of the CogVideoX-2B
    variant: 3/4 of the channels encode space (the 2D grid, w first), 1/4
    time, time first in the output."""
    h, w = spatial_size
    dim_s = embed_dim // 4 * 3
    dim_t = embed_dim // 4
    gh = np.arange(h, dtype=np.float64) / spatial_interpolation_scale
    gw = np.arange(w, dtype=np.float64) / spatial_interpolation_scale
    grid = np.stack(np.meshgrid(gw, gh), axis=0).reshape([2, 1, h, w])
    emb_h = get_1d_sincos_pos_embed_np(dim_s // 2, grid[1].reshape(-1))
    emb_w = get_1d_sincos_pos_embed_np(dim_s // 2, grid[0].reshape(-1))
    spatial = np.concatenate([emb_h, emb_w], axis=1)                   # [H*W, dim_s]
    gt = np.arange(temporal_size, dtype=np.float64) / temporal_interpolation_scale
    temporal = get_1d_sincos_pos_embed_np(dim_t, gt)                    # [T, dim_t]
    spatial = np.broadcast_to(spatial[None], (temporal_size, h * w, dim_s))
    temporal = np.broadcast_to(temporal[:, None], (temporal_size, h * w, dim_t))
    return np.concatenate([temporal, spatial], axis=-1)


def apply_rotary_emb(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE. x: [..., S, D]; cos/sin: [S, D]; fp32 math."""
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    rotated = torch.cat([-x2, x1], dim=-1)
    return (x.float() * cos.float() + rotated.float() * sin.float()).to(x.dtype)


def timestep_embedding(
    timesteps: torch.Tensor,
    dim: int,
    flip_sin_to_cos: bool = True,
    downscale_freq_shift: float = 0.0,
    max_period: float = 10000.0,
) -> torch.Tensor:
    """Sinusoidal timestep features (diffusers `Timesteps`): [B] -> [B, dim] fp32."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half - downscale_freq_shift)
    emb = torch.exp(exponent)[None, :] * timesteps.float()[:, None]
    sin, cos = torch.sin(emb), torch.cos(emb)
    if flip_sin_to_cos:
        return torch.cat([cos, sin], dim=-1)
    return torch.cat([sin, cos], dim=-1)

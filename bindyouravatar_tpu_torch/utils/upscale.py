"""Tiled super-resolution upscaling: the port of
`bindyouravatar_tpu/utils/upscale.py` (reference `util/utils.py:598-722`).

The model runs over overlapping tiles whose edges are feathered; the result
is `sum(tile * mask) / sum(mask)`, the reference's out / out_div blend.  As
JAX's: every tile has the full tile size (boundary tile origins are clamped
inward instead of the tiles shrinking), and the tiles go through the model
as one batch (or `batch_tiles` at a time).  A pointwise upscaler gives the
untiled result exactly through this path.

Deliberate deviation: `_feather_mask` clamps the feather to each side's
length.  JAX's raises a broadcasting error when `feather > n` (its ramp
slice is n long, its multiplier `feather` long; the wrapping indices of its
second line never run), which `tiled_scale` hits on an image smaller than
the overlap.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import numpy as np
import torch


def get_tiled_scale_steps(width: int, height: int, tile_x: int, tile_y: int,
                          overlap: int) -> int:
    """Tile count (reference `util/utils.py:598-599`; the same formula)."""
    return math.ceil(height / (tile_y - overlap)) * math.ceil(width / (tile_x - overlap))


def _origins(size: int, tile: int, overlap: int) -> np.ndarray:
    """Clamped full-tile origins covering [0, size) with `overlap` overlap."""
    if size <= tile:
        return np.array([0], np.int32)
    pos = np.arange(0, size, tile - overlap)
    return np.minimum(pos[pos < size], size - tile).astype(np.int32)


def _feather_mask(shape: Tuple[int, int], feather: int,
                  device: torch.device | str = "cpu") -> torch.Tensor:
    """Linear edge feather, multiplicative per axis (the reference's
    in-place `mask.narrow(...) *= (t + 1) / feather` loop), the feather
    clamped to each axis's length (see the module docstring)."""
    m = torch.ones(shape, dtype=torch.float32, device=device)
    for ax, n in enumerate(shape):
        f = min(feather, n)
        ramp = torch.ones(n, dtype=torch.float32, device=device)
        t = (torch.arange(f, dtype=torch.float32, device=device) + 1.0) / f
        ramp[:f] *= t
        ramp[n - 1 - torch.arange(f, device=device)] *= t
        m = m * (ramp[:, None] if ax == 0 else ramp[None, :])
    return m


def tiled_scale(samples: torch.Tensor, function: Callable[[torch.Tensor], torch.Tensor],
                tile_x: int = 64, tile_y: int = 64, overlap: int = 8,
                upscale_amount: float = 4, out_channels: int = 3,
                batch_tiles: int = 0) -> torch.Tensor:
    """Upscale [B, C, H, W] by running `function` over feather-blended tiles
    (reference `tiled_scale`, `util/utils.py:661-676`) -> float32 [B,
    out_channels, H * u, W * u].

    `function` maps [N, C, tile_y, tile_x] -> [N, out_channels, tile_y * u,
    tile_x * u]; `batch_tiles` > 0 runs it on that many tiles at a time,
    0 on all tiles at once."""
    b, c, h, w = samples.shape
    u = upscale_amount
    tile_y, tile_x = min(tile_y, h), min(tile_x, w)      # an image smaller than a tile
    oy, ox = _origins(h, tile_y, overlap), _origins(w, tile_x, overlap)
    uh, uw = round(h * u), round(w * u)
    uty, utx = round(tile_y * u), round(tile_x * u)
    mask = _feather_mask((uty, utx), round(overlap * u), samples.device)

    tiles = torch.stack([samples[i, :, y:y + tile_y, x:x + tile_x]
                         for i in range(b) for y in oy for x in ox])
    step = batch_tiles if batch_tiles else tiles.shape[0]
    up = torch.cat([function(tiles[i:i + step]) for i in range(0, tiles.shape[0], step)])
    up = up.float() * mask                                # [B * T, oc, uty, utx]

    out = torch.zeros((b, out_channels, uh, uw), dtype=torch.float32, device=samples.device)
    div = torch.zeros((uh, uw), dtype=torch.float32, device=samples.device)
    t = 0
    for i in range(b):
        for y in oy:
            for x in ox:
                py, px = round(int(y) * u), round(int(x) * u)
                out[i, :, py:py + uty, px:px + utx] += up[t]
                if i == 0:
                    div[py:py + uty, px:px + utx] += mask
                t += 1
    return out / div


def upscale(model_fn: Callable[[torch.Tensor], torch.Tensor], frames: torch.Tensor,
            scale: float = 4.0, tile: int = 512, overlap: int = 32,
            batch_tiles: int = 0) -> torch.Tensor:
    """Reference `upscale()` (`util/utils.py:686-716`): 512 / 32 tiling over
    a [T, C, H, W] frame stack."""
    return tiled_scale(frames, model_fn, tile_x=tile, tile_y=tile, overlap=overlap,
                       upscale_amount=scale, out_channels=frames.shape[1],
                       batch_tiles=batch_tiles)


def upscale_batch_and_concatenate(model_fn, latents: torch.Tensor, scale: float = 4.0,
                                  **kw) -> torch.Tensor:
    """Reference `upscale_batch_and_concatenate` (`util/utils.py:719-725`):
    the tiled upscale of each sample of a [B, T, C, H, W] batch."""
    return torch.stack([upscale(model_fn, latents[i], scale=scale, **kw)
                        for i in range(latents.shape[0])])

"""Identity masks -> teacher routing (the port's copy of the JAX package's
`utils/masks.py`, host-side numpy).

The training data path turns two per-frame pixel masks into the latent-grid
index mask (-1 background / 0 id 1 / 1 id 2), the clean teacher routing
(one-hot, OR-reduced over time) and the noisy teacher that is injected
during training.  The functions take a `numpy.random.Generator` and draw
from it in the JAX package's order, so both give the same teacher masks
from the same seed.  The CLI's `--tracking_mask_dir` turns SAM2 mask
files into a forced routing (`masks_to_routing_logits`).

The resize is the JAX package's numpy formula, operation for operation: a
binary mask's edges land exactly on 0.5 when it is downsampled (720 -> 45
puts column 22's sample at pixel 359.5), and the `> 0.5` of
`masks_to_index_mask` is decided there, so a resize with another order of
float operations could flip those cells.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np


def resize_mask_trilinear(mask: np.ndarray, out_t: int, out_h: int, out_w: int) -> np.ndarray:
    """[T, H, W] float mask -> [out_t, out_h, out_w], trilinear with
    half-pixel centres, no antialias, edge clamp (torch `F.interpolate`
    semantics, the reference's `resize_mask`)."""
    src = np.ascontiguousarray(mask, np.float32)
    t, h, w = src.shape

    def axis_idx(n_out, n_in):
        f = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
        lo = np.clip(np.floor(f).astype(int), 0, n_in - 1)
        hi = np.clip(lo + 1, 0, n_in - 1)
        frac = np.clip(f - np.floor(f), 0.0, 1.0)
        frac = np.where(f < 0, 0.0, frac)
        return lo, hi, frac.astype(np.float32)

    t0, t1, ft = axis_idx(out_t, t)
    y0, y1, fy = axis_idx(out_h, h)
    x0, x1, fx = axis_idx(out_w, w)

    def gather(ti, yi, xi):
        return src[np.ix_(ti, yi, xi)]

    fx_, fy_, ft_ = fx[None, None, :], fy[None, :, None], ft[:, None, None]
    c00 = gather(t0, y0, x0) * (1 - fx_) + gather(t0, y0, x1) * fx_
    c01 = gather(t0, y1, x0) * (1 - fx_) + gather(t0, y1, x1) * fx_
    c10 = gather(t1, y0, x0) * (1 - fx_) + gather(t1, y0, x1) * fx_
    c11 = gather(t1, y1, x0) * (1 - fx_) + gather(t1, y1, x1) * fx_
    c0 = c00 * (1 - fy_) + c01 * fy_
    c1 = c10 * (1 - fy_) + c11 * fy_
    return (c0 * (1 - ft_) + c1 * ft_).astype(np.float32)


def masks_to_index_mask(mask1: np.ndarray, mask2: np.ndarray,
                        latent_frames: int, grid_h: int, grid_w: int) -> np.ndarray:
    """Two per-frame binary masks [T_px, H, W] -> index mask [T * Hg * Wg]:
    -1 background / 0 id 1 / 1 id 2 (id 2 wins overlaps, the reference's
    order)."""
    m1 = resize_mask_trilinear(mask1, latent_frames, grid_h, grid_w) > 0.5
    m2 = resize_mask_trilinear(mask2, latent_frames, grid_h, grid_w) > 0.5
    idx = np.full((latent_frames, grid_h, grid_w), -1, np.int64)
    idx[m1] = 0
    idx[m2] = 1
    return idx.reshape(-1)


def index_mask_to_routing(index_mask: np.ndarray, num_ids: int = 2) -> np.ndarray:
    """Index mask [S] -> one-hot routing [1, S, num_ids] (background rows
    all zero)."""
    out = np.zeros((1, index_mask.shape[0], num_ids), np.float32)
    for i in range(num_ids):
        out[0, index_mask == i, i] = 1.0
    return out


def masks_to_routing_logits(mask_dir: str, latent_frames: int = 13, grid_h: int = 30,
                            grid_w: int = 45) -> np.ndarray:
    """A SAM2 tracking-mask directory (`{1,2}/annotated_frame_%05d.png`,
    reference `tools/sam2_tools.py`) -> one-hot routing [1, S, 2] on the
    latent grid."""
    from PIL import Image

    def load_dir(d):
        files = sorted(f for f in os.listdir(d) if f.endswith(".png"))
        return np.stack([np.asarray(Image.open(os.path.join(d, f)).convert("L"),
                                    dtype=np.float32) / 255.0 for f in files])

    idx = masks_to_index_mask(load_dir(os.path.join(mask_dir, "1")),
                              load_dir(os.path.join(mask_dir, "2")),
                              latent_frames, grid_h, grid_w)
    return index_mask_to_routing(idx)


def noisy_teacher_routing(index_mask: np.ndarray, grid: Tuple[int, int, int],
                          rng: np.random.Generator, num_ids: int = 2,
                          corrupt_frac: float = 0.1, noise_std: float = 0.1,
                          drop_prob: float = 0.0) -> np.ndarray:
    """The noisy teacher injected during training (reference
    `transformer.py:741-774`): one-hot routing, temporal OR-reduce and
    repeat, `corrupt_frac` of the entries replaced by uniforms, N(0,
    noise_std) added, clamped to [0, 1], dropped whole with `drop_prob`.
    Draws: a permutation, the uniforms, the normals, one coin.  -> [S, I]."""
    t, h, w = grid
    r = index_mask_to_routing(index_mask, num_ids)[0]
    r = r.reshape(t, h, w, num_ids).max(axis=0, keepdims=True)
    r = np.broadcast_to(r, (t, h, w, num_ids)).reshape(-1, num_ids).copy()
    n_rand = int(r.size * corrupt_frac)
    flat = r.reshape(-1)
    pick = rng.permutation(r.size)[:n_rand]
    flat[pick] = rng.random(n_rand, dtype=np.float32)
    r = flat.reshape(-1, num_ids)
    r = r + rng.normal(0.0, noise_std, r.shape).astype(np.float32)
    r = np.clip(r, 0.0, 1.0)
    if rng.random() < drop_prob:
        r = np.zeros_like(r)
    return r

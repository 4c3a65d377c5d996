"""Patchify / unpatchify for the DiT (CogVideoXPatchEmbed semantics).

Port of `bindyouravatar_tpu/ops/patch.py`: the 2x2 stride-2 patch conv is a
reshape followed by one matmul, with feature index c*p*p + dy*p + dx.
"""

from __future__ import annotations

from typing import Tuple

import torch


def patchify(latents: torch.Tensor, patch_size: int) -> torch.Tensor:
    """[B, T, C, H, W] -> [B, T*(H/p)*(W/p), C*p*p]."""
    b, t, c, h, w = latents.shape
    p = patch_size
    x = latents.reshape(b, t, c, h // p, p, w // p, p)
    x = x.permute(0, 1, 3, 5, 2, 4, 6)            # [B,T,H/p,W/p,C,p,p]
    return x.reshape(b, t * (h // p) * (w // p), c * p * p)


def unpatchify(tokens: torch.Tensor, grid: Tuple[int, int, int],
               out_channels: int, patch_size: int) -> torch.Tensor:
    """[B, T*Hg*Wg, C*p*p] -> [B, T, C, Hg*p, Wg*p]."""
    b = tokens.shape[0]
    t, hg, wg = grid
    p = patch_size
    x = tokens.reshape(b, t, hg, wg, out_channels, p, p)
    x = x.permute(0, 1, 4, 2, 5, 3, 6)            # [B,T,C,Hg,p,Wg,p]
    return x.reshape(b, t, out_channels, hg * p, wg * p)

"""Training losses in torch: the v-prediction diffusion loss and the six
routing losses (port of `bindyouravatar_tpu/training/losses.py`).

Same grid convention: with `compat_transposed=True` (the default, the
reference's training behaviour) the flat T*H*W tokens are viewed as
(T, W, H) for the smoothness and distribution losses; `False` uses the
canonical (T, H, W) layout.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def bce(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Element-wise binary cross entropy, pred clamped, target not."""
    p = pred.clamp(eps, 1.0 - eps)
    return -target * torch.log(p) - (1.0 - target) * torch.log(1.0 - p)


def focal_loss(pred, target, alpha: float = 0.5, gamma: float = 2.0, eps: float = 1e-6):
    """The reference's focal loss (defined there, unused by training)."""
    p = pred.clamp(eps, 1.0 - eps)
    t = target.clamp(eps, 1.0 - eps)
    ce = -t * torch.log(p) - (1.0 - t) * torch.log(1.0 - p)
    pt = p * t + (1.0 - p) * (1.0 - t)
    return (alpha * t + (1 - alpha) * (1 - t)) * (1 - pt) ** gamma * ce


def _as_grid(routing: torch.Tensor, grid: Tuple[int, int, int],
             compat_transposed: bool) -> torch.Tensor:
    """[..., S, I] -> [..., T, A, B, I] with (A, B) = (W, H) in compat mode,
    (H, W) canonically."""
    t, h, w = grid
    lead, i = routing.shape[:-2], routing.shape[-1]
    return routing.reshape(lead + ((t, w, h, i) if compat_transposed else (t, h, w, i)))


def routing_bce_loss(routing_logits: torch.Tensor, teacher: torch.Tensor) -> torch.Tensor:
    """BCE against the clean teacher; routing_logits [L, B, S, I], teacher
    [B, S, I]; mean over everything, a NaN batch entry counting 0."""
    loss = bce(routing_logits, teacher[None]).mean(dim=(2, 3)).mean(dim=0)     # [B]
    return torch.where(torch.isnan(loss), torch.zeros_like(loss), loss).mean()


def consistency_loss(routing_logits: torch.Tensor) -> torch.Tensor:
    """Unbiased variance across layers, averaged."""
    if routing_logits.shape[0] < 2:
        return routing_logits.new_zeros(())
    return routing_logits.var(dim=0, unbiased=True).mean(dim=(1, 2)).mean()


def temporal_diff_loss(routing_logits: torch.Tensor, grid: Tuple[int, int, int],
                       compat_transposed: bool = True) -> torch.Tensor:
    """L2 norm of frame-to-frame differences per (layer, batch), averaged."""
    g = _as_grid(routing_logits, grid, compat_transposed)
    d = (g[:, :, 1:] - g[:, :, :-1]).float()
    per = torch.sqrt((d ** 2).sum(dim=(2, 3, 4, 5)) + 1e-12)
    return per.mean(dim=0).mean()


def spatial_diff_loss(routing_logits: torch.Tensor, grid: Tuple[int, int, int],
                      compat_transposed: bool = True) -> torch.Tensor:
    """L2 norms of the differences along both spatial axes, averaged."""
    g = _as_grid(routing_logits, grid, compat_transposed)
    dh = (g[:, :, :, 1:] - g[:, :, :, :-1]).float()
    dw = (g[:, :, :, :, 1:] - g[:, :, :, :, :-1]).float()
    nh = torch.sqrt((dh ** 2).sum(dim=(2, 3, 4, 5)) + 1e-12)
    nw = torch.sqrt((dw ** 2).sum(dim=(2, 3, 4, 5)) + 1e-12)
    return (nh + nw).mean(dim=0).mean()


def _side_sums(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """g [L, B, T, A, B2, I] -> the thresholded means over the first and
    last `(A - 1) // 2` slices of axis A, each [L, B, T, I]."""
    a = g.shape[3]
    half = (a - 1) // 2
    left, right = g[:, :, :, :half], g[:, :, :, half + 1:]
    lm = (left * (left >= 0.01)).sum(dim=(3, 4)) / (half * g.shape[4])
    rm = (right * (right >= 0.01)).sum(dim=(3, 4)) / (half * g.shape[4])
    return lm, rm


def spatial_distribution_loss(routing_logits: torch.Tensor, grid: Tuple[int, int, int],
                              compat_transposed: bool = True) -> torch.Tensor:
    """Mass on both sides at once."""
    lm, rm = _side_sums(_as_grid(routing_logits, grid, compat_transposed))
    return (lm * rm).mean(dim=(2, 3)).mean(dim=0).mean()


def id_distribution_loss(routing_logits: torch.Tensor, grid: Tuple[int, int, int],
                         compat_transposed: bool = True) -> torch.Tensor:
    """Both identities on the same side."""
    lm, rm = _side_sums(_as_grid(routing_logits, grid, compat_transposed))
    left = (lm[..., 0] * lm[..., 1]).mean(dim=2)
    right = (rm[..., 0] * rm[..., 1]).mean(dim=2)
    return ((left + right) / 2.0).mean(dim=0).mean()


def _mask(dense_mask: torch.Tensor, shape) -> torch.Tensor:
    m = dense_mask.float()
    if m.ndim == len(shape) - 1:
        m = m[:, :, None]
    return m.expand(shape)


def mask_count(dense_mask: torch.Tensor, shape) -> torch.Tensor:
    """The elements a dense mask selects in a loss over latents of `shape`."""
    return _mask(dense_mask, tuple(shape)).sum()


def diffusion_loss(model_output: torch.Tensor, noisy_latents: torch.Tensor,
                   clean_latents: torch.Tensor, timesteps: torch.Tensor, schedule,
                   dense_mask: Optional[torch.Tensor] = None,
                   mask_denominator: Optional[torch.Tensor] = None) -> torch.Tensor:
    """v-prediction loss weighted 1 / (1 - a_t): the prediction mapped to x0
    by `schedule.get_velocity(noisy, model_output, t)` against the clean
    latents; an optional per-token dense mask ([B, T, H, W] or the
    latents' shape) restricts it, the masked sum divided by the mask's
    element count (at least 1) or by `mask_denominator` (a sharded batch
    divides by the whole batch's count)."""
    pred = schedule.get_velocity(noisy_latents, model_output, timesteps)
    w = schedule.loss_weight(timesteps)
    w = w.reshape(w.shape + (1,) * (pred.ndim - w.ndim))
    sq = w * (pred - clean_latents.float()) ** 2
    if dense_mask is not None:
        m = _mask(dense_mask, sq.shape)
        den = m.sum().clamp_min(1.0) if mask_denominator is None else mask_denominator
        return (sq * m).sum() / den
    return sq.reshape(sq.shape[0], -1).mean(dim=1).mean()

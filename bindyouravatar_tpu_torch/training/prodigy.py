"""Prodigy (parameter-free Adam), the port of the JAX package's
`training/prodigy.py` (Mishchenko & Defazio, arXiv 2306.06101; the state
recursion and defaults of `prodigyopt.Prodigy`):

  dlr     = d * lr * bias_correction
  num     = sqrt(beta3) * num + (d / d0) * dlr * <g, x0 - x>
  s       = sqrt(beta3) * s + (d / d0) * dlr * g      ((d / d0) * d with safeguard_warmup)
  m       = beta1 * m + (1 - beta1) * d * g
  v       = beta2 * v + (1 - beta2) * d^2 * g^2
  d_hat   = d_coef * num / ||s||_1
  d       = min(max(d, d_hat) [only while d == d0], d_max, d * growth_rate)
  x       = x - dlr * m / (sqrt(v) + d * eps) [- dlr * weight_decay * x if decoupled]

`d`, `d_max`, `d_numerator` are scalars of one optimizer: with `is_diff_lr`
each learning-rate group has its own (JAX's `optax.multi_transform` gives
each group its own prodigy), and the two global sums run over the group's
tensors.  They are fp32 0-d tensors on the parameters' device, summed over
JAX's leaves in JAX's tree order (`adafactor.stacked_leaves`).  As in JAX,
`decouple=False` applies no weight decay at all.

Under FSDP (`shards.py`) the two sums <g, x0 - x> and ||s||_1 add the
split tensors' partial sums over the fsdp group (one all-reduce of both)
to the replicated tensors' sums, which every rank counts once: `d`,
`d_max` and `d_numerator` stay equal on every rank.
"""

from __future__ import annotations

from typing import List, Mapping, Optional

import torch

from .adafactor import stacked_leaves
from .shards import ShardAware


class Prodigy(ShardAware):
    """State: per tensor `exp_avg`, `exp_avg_sq`, `s` and `p0` (fp32); per
    group label `d`, `d_max` and `d_numerator` (fp32 0-d tensors)."""

    PARAM_LIKE = ("exp_avg", "exp_avg_sq", "s", "p0")

    # prodigyopt's defaults, which the trainer keeps (its flags are the rest)
    d0, d_coef, growth = 1e-6, 1.0, float("inf")

    def __init__(self, b1: float = 0.9, b2: float = 0.999, beta3: Optional[float] = None,
                 eps: float = 1e-8, weight_decay: float = 0.0, decouple: bool = True,
                 use_bias_correction: bool = False, safeguard_warmup: bool = False):
        self.b1, self.b2, self.beta3, self.eps = b1, b2, beta3, eps
        self.wd, self.decouple = weight_decay, decouple
        self.bias_correction, self.safeguard = use_bias_correction, safeguard_warmup

    def init(self, params: Mapping[str, torch.Tensor], groups: Mapping[str, List[str]]):
        f32 = dict(dtype=torch.float32)
        zeros = lambda: {k: torch.zeros_like(p, **f32) for k, p in params.items()}
        dev = next(iter(params.values())).device
        scalar = lambda v: {g: torch.tensor(v, device=dev, **f32) for g in groups}
        return {"exp_avg": zeros(), "exp_avg_sq": zeros(), "s": zeros(),
                "p0": {k: p.detach().float().clone() for k, p in params.items()},
                "d": scalar(self.d0), "d_max": scalar(self.d0), "d_numerator": scalar(0.0)}

    @torch.no_grad()
    def step(self, params: Mapping[str, torch.Tensor], grads: Mapping[str, torch.Tensor],
             state, groups: Mapping[str, List[str]], lrs: Mapping[str, float], count: int) -> None:
        f32 = torch.float32
        b1, b2 = self.b1, self.b2
        b2_t = torch.tensor(b2, dtype=f32)
        b3 = torch.sqrt(b2_t) if self.beta3 is None else torch.tensor(self.beta3, dtype=f32)
        sqrt_b3 = float(torch.sqrt(b3))
        bc = 1.0
        if self.bias_correction:
            t = torch.tensor(float(count + 1), dtype=f32)
            bc = float(torch.sqrt(1.0 - b2_t ** t) / (1.0 - torch.tensor(b1, dtype=f32) ** t))
        for label, names in groups.items():
            leaves = stacked_leaves(names)
            lr = lrs[label]
            d = state["d"][label]
            dlr = d * lr * bc
            g32 = {k: grads[k].float() for k in names}
            dots = {k: (g32[k] * (state["p0"][k] - params[k].float())).sum() for k in names}
            s_coef = (d / self.d0) * (d if self.safeguard else dlr)
            for k in names:
                s = state["s"][k]
                s.copy_(s * sqrt_b3 + s_coef * g32[k])
            dot, denom = self._sums(leaves, dots,
                                    {k: state["s"][k].abs().sum() for k in names})
            num = state["d_numerator"][label] * sqrt_b3 + (d / self.d0) * dlr * dot
            for k in names:
                g, m, v = g32[k], state["exp_avg"][k], state["exp_avg_sq"][k]
                m.copy_(m * b1 + (1.0 - b1) * d * g)
                v.copy_(v * b2 + (1.0 - b2) * d * d * g * g)
            # prodigyopt's order: d_hat from the fresh accumulators, skipped
            # while lr == 0 or the denominator is empty; the new d enters
            # this step's eps term while dlr keeps the old one
            live = (denom > 0.0) & (lr > 0.0)
            d_hat = torch.where(live, self.d_coef * num / torch.where(denom > 0.0, denom, 1.0), d)
            d_b = torch.where(d == self.d0, torch.maximum(d, d_hat), d)
            d_max = torch.where(live, torch.maximum(state["d_max"][label], d_hat),
                                state["d_max"][label])
            new_d = torch.where(live, torch.minimum(d_max, d_b * self.growth), d)
            for k in names:
                p = params[k]
                upd = -dlr * state["exp_avg"][k] / (torch.sqrt(state["exp_avg_sq"][k])
                                                    + new_d * self.eps)
                if self.wd != 0.0 and self.decouple:
                    upd = upd - dlr * self.wd * p.float()
                p.add_(upd.to(p.dtype))
            state["d"][label].copy_(new_d)
            state["d_max"][label].copy_(d_max)
            state["d_numerator"][label].copy_(num)

    def _sums(self, leaves, *terms):
        """Each of `terms` (name -> 0-d tensor) summed over the leaves'
        tensors in JAX's tree order; under FSDP the split tensors' partial
        sums are added over the fsdp group (one all-reduce for all terms)
        to the replicated tensors' sums."""
        zero = next(iter(terms[0].values())).new_zeros(())
        total = lambda t, keep: sum((sum((t[k] for k in leaf if keep(k)), zero)
                                     for leaf in leaves.values()), zero)
        if not self.parts:
            return [total(t, lambda k: True) for t in terms]
        split = self.all_sum(torch.stack([total(t, lambda k: k in self.parts) for t in terms]))
        return [split[i] + total(t, lambda k: k not in self.parts) for i, t in enumerate(terms)]

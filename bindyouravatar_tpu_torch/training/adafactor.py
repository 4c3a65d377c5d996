"""Adafactor as the JAX trainer runs it: `optax.adafactor(lr)` with optax's
defaults (optax 0.2.6, `_src/alias.py:adafactor`, `_src/factorized.py`),
one tensor at a time, in place.

The chain, per trainable tensor g:
  1. `scale_by_factored_rms`: decay `1 - (t + 1)^-0.8` (t the update count),
     `g^2 + 1e-30` averaged into row and column statistics over the two
     largest dims when the second largest has at least 128 elements
     (factored), else into a full second moment; the update is g scaled
     by their inverse square roots;
  2. `clip_by_block_rms(1.0)`: the update divided by max(1, its RMS);
  3. the learning rate;
  4. `scale_by_param_block_rms(1e-3)`: times max(RMS of the parameter, 1e-3);
  5. the sign flip.

The "blocks" of steps 2 and 4 are JAX's leaves.  JAX stacks the layers of
`blocks`, `audio_layers`, `perceiver` and `router_layers` into one [L, ...]
leaf, so one RMS covers all L layers of a tensor; the port holds one tensor
per layer, and `stacked_leaves` groups them back into JAX's leaves, so the
two RMS values are taken over the same elements as in JAX.  The factoring is
per layer in both (the stacked axis is never one of the two largest while L
< 128), and its update is symmetric in rows and columns, so a tensor stored
transposed (torch's [out, in] against flax's [in, out]) gets the same
update.

Under FSDP (`shards.py`) the factored dims are chosen on the whole
tensor's shape (a rank's part can flip which dim is largest, or fall under
the 128 threshold); a mean over the split dim, of g^2 into a statistic or
of `v_row` in its row factor, is a sum over the fsdp group divided by the
whole size; and the two block RMS values sum their squares over the group.
The statistic reduced over the split dim is then whole on every rank; the
other stays split like the tensor (`state_part`).
"""

from __future__ import annotations

import math
import re
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..parallel.sharding import Part
from .shards import ShardAware

# the port's per-layer ModuleLists that JAX scan-stacks into one leaf
_STACKED = re.compile(r"^(blocks|audio_layers|perceivers|router_layers)\.(\d+)\.(.+)$")


def stacked_leaves(names: Iterable[str]) -> Dict[str, List[str]]:
    """JAX's leaves over the port's tensor names: `blocks.{i}.x` for every
    layer i is the one leaf `blocks.*.x` (names in layer order); any other
    name is a leaf of its own.  Keys in sorted order, which is JAX's tree
    order up to the renamed leaves."""
    out: Dict[str, List[Tuple[int, str]]] = {}
    for n in names:
        m = _STACKED.match(n)
        key = f"{m.group(1)}.*.{m.group(3)}" if m else n
        out.setdefault(key, []).append((int(m.group(2)) if m else 0, n))
    return {k: [n for _, n in sorted(out[k])] for k in sorted(out)}


def factored_dims(shape: Tuple[int, ...], min_dim_size_to_factor: int = 128
                  ) -> Optional[Tuple[int, int]]:
    """optax's `_factored_dims`: (second largest, largest) dim indices, or
    None when there are fewer than 2 dims or the second largest is small."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


def _rms(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt(mean of squares) over every element of `tensors`, fp32."""
    n = sum(t.numel() for t in tensors)
    return torch.sqrt(sum(t.float().square().sum() for t in tensors) / n)


class Adafactor(ShardAware):
    """optax.adafactor(lr) with its defaults (the only ones the trainer
    uses).  State per tensor: `v_row` and `v_col` (factored) or `v` (not
    factored), fp32."""
    decay_rate, min_dim, eps, clip, min_scale = 0.8, 128, 1e-30, 1.0, 1e-3
    PARAM_LIKE = ("v",)

    def _whole_shape(self, k: str, t: torch.Tensor) -> Tuple[int, ...]:
        part = self.parts.get(k)
        return part.shape if part is not None else tuple(t.shape)

    def state_part(self, kind: str, name: str) -> Optional[Part]:
        part = self.parts.get(name)
        if part is None or kind == "v":
            return part
        d1, d0 = factored_dims(part.shape, self.min_dim)
        return part.without(d0 if kind == "v_row" else d1)

    def _mean(self, x: torch.Tensor, dim: int, part: Optional[Part],
              keepdim: bool = False) -> torch.Tensor:
        """x's mean over `dim` of the whole tensor that `part` locates."""
        if part is None or part.dim != dim:
            return x.mean(dim=dim, keepdim=keepdim)
        return self.all_sum(x.sum(dim=dim, keepdim=keepdim)) / part.shape[dim]

    def init(self, params: Mapping[str, torch.Tensor], groups=None
             ) -> Dict[str, Dict[str, torch.Tensor]]:
        state = {"v_row": {}, "v_col": {}, "v": {}}
        for k, p in params.items():
            dims = factored_dims(self._whole_shape(k, p), self.min_dim)
            if dims is None:
                state["v"][k] = torch.zeros_like(p, dtype=torch.float32)
            else:
                d1, d0 = dims
                shape = list(p.shape)
                state["v_row"][k] = p.new_zeros(shape[:d0] + shape[d0 + 1:], dtype=torch.float32)
                state["v_col"][k] = p.new_zeros(shape[:d1] + shape[d1 + 1:], dtype=torch.float32)
        return state

    def _scaled(self, g: torch.Tensor, k: str, state, decay: float) -> torch.Tensor:
        """Step 1 for one tensor: the update, and the statistics in place."""
        g2 = g.square() + self.eps
        if k in state["v"]:
            v = state["v"][k]
            v.copy_(decay * v + (1.0 - decay) * g2)
            return g * v.pow(-0.5)
        part = self.parts.get(k)
        d1, d0 = factored_dims(self._whole_shape(k, g), self.min_dim)
        v_row, v_col = state["v_row"][k], state["v_col"][k]
        v_row.copy_(decay * v_row + (1.0 - decay) * self._mean(g2, d0, part))
        v_col.copy_(decay * v_col + (1.0 - decay) * self._mean(g2, d1, part))
        reduced_d1 = d1 - 1 if d1 > d0 else d1
        row_mean = self._mean(v_row, reduced_d1, self.state_part("v_row", k), keepdim=True)
        row_factor = (v_row / row_mean).pow(-0.5)
        return g * row_factor.unsqueeze(d0) * v_col.pow(-0.5).unsqueeze(d1)

    @torch.no_grad()
    def step(self, params: Mapping[str, torch.Tensor], grads: Mapping[str, torch.Tensor],
             state, groups: Mapping[str, List[str]], lrs: Mapping[str, float], count: int) -> None:
        """One update of every tensor of every group (label -> names), the
        group's learning rate `lrs[label]`; `count` updates came before."""
        t = np.float32(count + 1)
        decay = float(np.float32(1.0) - t ** np.float32(-self.decay_rate))
        for label, names in groups.items():
            for leaf in stacked_leaves(names).values():
                upd = [self._scaled(grads[k].float(), k, state, decay) for k in leaf]
                u_rms, p_rms = self._leaf_rms(leaf, upd, [params[k] for k in leaf])
                denom = torch.clamp(u_rms / self.clip, min=1.0)
                scale = torch.where(p_rms <= self.min_scale, p_rms.new_tensor(self.min_scale),
                                    p_rms)
                for k, u in zip(leaf, upd):
                    p = params[k]
                    p.add_((-(u / denom * lrs[label]) * scale).to(p.dtype))

    def _leaf_rms(self, leaf: List[str], upd: List[torch.Tensor], params: List[torch.Tensor]):
        """The RMS of the update and of the parameter over the whole leaf:
        the split tensors' sums of squares summed over the fsdp group."""
        if not any(k in self.parts for k in leaf):
            return _rms(upd), _rms(params)
        sq = lambda ts, split: sum((t.float().square().sum() for k, t in zip(leaf, ts)
                                    if (k in self.parts) == split), upd[0].new_zeros(()))
        whole = self.all_sum(torch.stack([sq(upd, True), sq(params, True)]))
        n = sum(math.prod(self._whole_shape(k, t)) for k, t in zip(leaf, upd))
        return (torch.sqrt((whole[0] + sq(upd, False)) / n),
                torch.sqrt((whole[1] + sq(params, False)) / n))

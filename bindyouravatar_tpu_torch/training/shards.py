"""What an optimizer needs to keep its statistics whole under FSDP.

JAX runs every optax optimizer on sharded leaves through GSPMD, which
inserts the collectives that a statistic over a whole tensor needs.  The
port's optimizers see each rank's part of a sharded tensor (`parallel.
sharding.Part`: the whole shape, the split dim, the part's start) and sum
over the fsdp group themselves where a statistic spans the split: adafactor's
factored means and block RMS, prodigy's two global sums, 8-bit AdamW's
block absmax.  Under dp x fsdp the group is this rank's fsdp group; the dp
replicas hold equal parts and equal gradients, so they compute the same.
A tensor that the FSDP rule leaves replicated has no part and is counted
once.  Without a mesh there are no parts and no group: every statistic is
local, as on one rank.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from ..parallel.sharding import Part


class ShardAware:
    """Base of the port's optimizers: `shard` hands them the parts and the
    group; `state_part` says where each kind of state tensor is split (for
    the checkpoint, which saves every tensor whole).  `PARAM_LIKE` are the
    kinds laid out as the parameter."""

    PARAM_LIKE: Tuple[str, ...] = ()
    parts: Mapping[str, Part] = {}
    group = None

    def shard(self, parts: Mapping[str, Part], group) -> None:
        self.parts, self.group = dict(parts), group

    def state_part(self, kind: str, name: str) -> Optional[Part]:
        return self.parts.get(name) if kind in self.PARAM_LIKE else None

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        """x summed over the fsdp group, in place (x itself on one rank)."""
        if self.group is not None:
            dist.all_reduce(x, group=self.group)
        return x

    def all_max(self, x: torch.Tensor) -> torch.Tensor:
        if self.group is not None:
            dist.all_reduce(x, op=dist.ReduceOp.MAX, group=self.group)
        return x

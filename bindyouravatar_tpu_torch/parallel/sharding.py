"""Parameter partitioning (FSDP) over the mesh's fsdp axis (port of
`bindyouravatar_tpu/parallel/sharding.py`).

The rule is JAX's, judged on the JAX leaf each port tensor comes from:
  * JAX stacks the layers of `blocks`, `perceiver`, `router_layers` and
    `audio_layers` into one [L, ...] leaf; the port holds one tensor per
    layer.  The size threshold (2^16 elements) is tested on the stacked
    size, L x numel, as JAX tests its leaf, and the stacked axis is never
    sharded;
  * the dim is JAX's choice (the largest dim divisible by the fsdp size,
    ties toward the later dim) mapped back through the converter's
    transposes: a Dense kernel [in, out] is the port's [out, in], so JAX's
    output-feature dim is the port's dim 0; conv kernels [kh, kw, in, out]
    / [kt, kh, kw, in, out] are the port's [out, in, kh, kw] / [out, in,
    kt, kh, kw]; every other tensor keeps its orientation.

`shard_params` places the model's tensors with FSDP2 (`fully_shard`): each
block, audio layer and router projection layer is a unit of its own (its
tensors gathered for its forward and backward, its gradients
reduce-scattered), the rest of the model one root unit; the tensors the rule
leaves replicated are `ignored_params`.  Over a (dp, fsdp) mesh with dp > 1
the units are replicated over dp (HSDP).  On an fsdp axis of size 1 the
tensors that the rule's threshold and dim choice would shard are still
wrapped, each over the one rank, while `param_specs` says replicated, as
JAX's does.  The perceivers stay in the root unit: the face injection calls
a perceiver's `to_out` after the perceiver's own forward
(`DiT._face_injection`).
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, Iterable, Mapping, Optional, Tuple

import torch
import torch.nn as nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Shard

from .mesh import AXIS_DATA, AXIS_FSDP

# the port's ModuleLists whose JAX leaves are scan-stacked [L, ...]
STACKED_PREFIXES = ("blocks", "perceivers", "router_layers", "audio_layers")
_STACKED = re.compile(r"^(%s)\.(\d+)\." % "|".join(STACKED_PREFIXES))
MIN_SIZE = 2 ** 16
# the ModuleLists whose layers are FSDP units of their own
_UNITS = ("blocks", "audio_layers", "router_layers")


def _jax_perm(name: str, ndim: int) -> Tuple[int, ...]:
    """perm[i] = the JAX (per-layer) dim of the port's dim i."""
    if name.endswith(".weight"):
        return {2: (1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}.get(ndim, tuple(range(ndim)))
    return tuple(range(ndim))


def layer_counts(names: Iterable[str]) -> Dict[str, int]:
    """Stacked prefix -> its number of layers among `names`."""
    seen: Dict[str, set] = {}
    for n in names:
        m = _STACKED.match(n)
        if m:
            seen.setdefault(m.group(1), set()).add(int(m.group(2)))
    return {k: len(v) for k, v in seen.items()}


def shard_dim(name: str, shape: Tuple[int, ...], fsdp_size: int, layers: int = 1,
              min_size: int = MIN_SIZE) -> Optional[int]:
    """The port dim JAX's rule shards for this tensor (`layers` is L for a
    layer of a stacked list), or None.  Without JAX's `fsdp_size <= 1`
    shortcut, which `param_specs` applies."""
    if math.prod(shape) * layers < min_size:
        return None
    perm = _jax_perm(name, len(shape))
    jshape = [0] * len(shape)
    for i, j in enumerate(perm):
        jshape[j] = shape[i]
    for d in sorted(range(len(jshape)), key=lambda d: (jshape[d], d), reverse=True):
        if jshape[d] % fsdp_size == 0 and jshape[d] >= fsdp_size:
            return perm.index(d)
    return None


def _named(params) -> Mapping[str, torch.Tensor]:
    return dict(params.named_parameters()) if isinstance(params, nn.Module) else params


def param_specs(params, fsdp_size: int) -> Dict[str, Optional[int]]:
    """Name -> the dim sharded over the fsdp axis, or None (replicated), for
    a module or a name -> tensor mapping (meta tensors do)."""
    named = _named(params)
    layers = layer_counts(named)
    out = {}
    for k, t in named.items():
        m = _STACKED.match(k)
        out[k] = None if fsdp_size <= 1 else shard_dim(
            k, tuple(t.shape), fsdp_size, layers[m.group(1)] if m else 1)
    return out


def shard_bytes(params, fsdp_size: int) -> Dict[str, int]:
    """Diagnostics: bytes in all, sharded, and held per device."""
    named = _named(params)
    specs = param_specs(named, fsdp_size)
    total = sharded = 0
    for k, t in named.items():
        n = t.numel() * t.element_size()
        total += n
        if specs[k] is not None:
            sharded += n
    return {"total": total, "sharded": sharded,
            "per_device": sharded // fsdp_size + (total - sharded)}


def fsdp_mesh(mesh: DeviceMesh) -> DeviceMesh:
    """The (dp, fsdp) sub-mesh FSDP runs on: fsdp alone when dp is 1."""
    return mesh[AXIS_FSDP] if mesh[AXIS_DATA].size() == 1 else mesh[AXIS_DATA, AXIS_FSDP]


def shard_params(model: nn.Module, mesh: DeviceMesh) -> nn.Module:
    """Place `model`'s tensors over the mesh per the rule (see the module
    docstring), in place; returns the model."""
    from torch.distributed.fsdp import fully_shard

    fsdp = mesh[AXIS_FSDP].size()
    named = dict(model.named_parameters())
    layers = layer_counts(named)
    dims = {}
    for k, t in named.items():
        m = _STACKED.match(k)
        dims[id(t)] = shard_dim(k, tuple(t.shape), fsdp, layers[m.group(1)] if m else 1)
    ignored = {t for t in named.values() if dims[id(t)] is None}
    place = lambda p: Shard(dims[id(p)])
    fm = fsdp_mesh(mesh)
    for prefix in _UNITS:
        for layer in getattr(model, prefix, ()):
            if any(dims[id(p)] is not None for p in layer.parameters()):
                fully_shard(layer, mesh=fm, shard_placement_fn=place, ignored_params=ignored)
    fully_shard(model, mesh=fm, shard_placement_fn=place, ignored_params=ignored)
    return model


def local(t: torch.Tensor) -> torch.Tensor:
    """This rank's part of `t` (the tensor itself when it is not sharded);
    writes to it write the parameter."""
    return t._local_tensor if isinstance(t, DTensor) else t


@dataclasses.dataclass(frozen=True)
class Part:
    """Where this rank's part of a whole tensor lies: the whole tensor's
    shape, the dim split over the fsdp group and the part's first index
    along it (FSDP2 splits as `torch.chunk` does: the last ranks' parts may
    be shorter, or empty)."""
    shape: Tuple[int, ...]
    dim: int
    start: int

    def without(self, dim: int) -> Optional["Part"]:
        """The part of a statistic reduced over `dim` (None: that statistic
        is whole on every rank once summed over the group)."""
        if dim == self.dim:
            return None
        shape = self.shape[:dim] + self.shape[dim + 1:]
        return Part(shape, self.dim - (dim < self.dim), self.start)


def param_part(p: torch.Tensor) -> Optional[Part]:
    """The `Part` of a parameter FSDP sharded over its mesh's fsdp axis
    (also over an axis of one rank), or None when it is not sharded."""
    if not isinstance(p, DTensor):
        return None
    coord = p.device_mesh.get_coordinate()
    for i, pl in enumerate(p.placements):
        if isinstance(pl, Shard):
            size = p.shape[pl.dim]
            chunk = -(-size // p.device_mesh.size(i))
            return Part(tuple(p.shape), pl.dim, min(coord[i] * chunk, size))
    return None


def _contiguous_stride(shape: Tuple[int, ...]) -> Tuple[int, ...]:
    stride, out = 1, []
    for n in reversed(shape):
        out.append(stride)
        stride *= n
    return tuple(reversed(out))


def gather_part(t: torch.Tensor, like: torch.Tensor, part: Optional[Part]) -> torch.Tensor:
    """The whole tensor of which `t` is this rank's `part`, split over
    parameter `like`'s fsdp axis (every rank must call it)."""
    if part is None:
        return t
    placements = [Shard(part.dim) if isinstance(pl, Shard) else pl for pl in like.placements]
    return DTensor.from_local(t, like.device_mesh, placements, shape=torch.Size(part.shape),
                              stride=_contiguous_stride(part.shape), run_check=False).full_tensor()


def narrow_part(full: torch.Tensor, part: Optional[Part], length: int) -> torch.Tensor:
    """This rank's `part` (`length` indices along its dim) of a whole
    tensor `full`."""
    return full if part is None else full.narrow(part.dim, part.start, length)

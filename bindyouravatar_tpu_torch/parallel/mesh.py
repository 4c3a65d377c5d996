"""The (dp, fsdp, tp) device mesh and the process group under it (port of
`bindyouravatar_tpu/parallel/mesh.py`).

The port is a multi-controller program: every rank runs the same script
(under `torchrun`, one process per GPU), where JAX has one controller
driving every device.  `init_distributed` joins the ranks into the default
process group; `create_mesh` lays them out as a (dp, fsdp, tp)
`DeviceMesh`.  JAX's `constrain_batch` is a GSPMD partitioner hint with no
counterpart here: each rank holds its own slice of the batch
(`local_batch`), so there is nothing to constrain.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

AXIS_DATA = "dp"
AXIS_FSDP = "fsdp"
AXIS_TENSOR = "tp"


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def create_mesh(dp: Optional[int] = None, fsdp: int = 1, tp: int = 1,
                device_type: str = "cuda") -> DeviceMesh:
    """A (dp, fsdp, tp) mesh over the world's ranks; `dp=None` takes the
    ranks that are left over.  On the card unless `device_type="cpu"` asks
    for a CPU mesh (there is no fallback when no GPU is found).  Needs
    `init_distributed` first when the world has more than one rank."""
    n = world_size()
    if dp is None:
        if n % (fsdp * tp) != 0:
            raise ValueError(f"{n} ranks not divisible by fsdp*tp={fsdp * tp}")
        dp = n // (fsdp * tp)
    if dp * fsdp * tp != n:
        raise ValueError(f"mesh {dp}x{fsdp}x{tp} != {n} ranks")
    return init_device_mesh(device_type, (dp, fsdp, tp),
                            mesh_dim_names=(AXIS_DATA, AXIS_FSDP, AXIS_TENSOR))


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: str = "nccl") -> None:
    """Join the default process group, once per process.  A no-op when it
    is already joined, and on one host when no `coordinator` is given and
    `torchrun`'s environment (`RANK`, `WORLD_SIZE`) is absent.  The backend
    is NCCL, on the card, unless `backend="gloo"` asks for CPU tensors;
    under NCCL the rank's device is `LOCAL_RANK`'s.  `coordinator` is an
    `init_method` URL (`tcp://host:port` or `file:///path`)."""
    if dist.is_initialized():
        return
    if coordinator is None and "RANK" not in os.environ:
        return
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", process_id or 0)))
    kw = {}
    if coordinator is not None:
        kw = dict(init_method=coordinator, world_size=num_processes, rank=process_id)
    dist.init_process_group(backend, **kw)


def batch_sharding(mesh: DeviceMesh):
    """The batch's placements: dim 0 sharded over dp and fsdp (dp-major, the
    rows `local_batch` gives each rank), replicated over tp (JAX's
    `P(("dp", "fsdp"))`)."""
    return [Shard(0) if name != AXIS_TENSOR else Replicate() for name in mesh.mesh_dim_names]


def replicated(mesh: DeviceMesh):
    return [Replicate()] * mesh.ndim


def batch_rank(mesh: Optional[DeviceMesh]):
    """(this rank's index along the flattened (dp, fsdp) axis, its size)."""
    if mesh is None:
        return 0, 1
    dp, fsdp = mesh[AXIS_DATA], mesh[AXIS_FSDP]
    return dp.get_local_rank() * fsdp.size() + fsdp.get_local_rank(), dp.size() * fsdp.size()


def local_batch(x: torch.Tensor, index: int, count: int, accum: int = 1) -> torch.Tensor:
    """This rank's rows of a global batch `x` [B, ...] cut into `accum`
    micro-batches: micro-batch i of the rank is rows [index * n, (index + 1)
    * n) of global micro-batch i (n = B / (accum * count)), so that the
    ranks' micro-batches together are the global ones."""
    b = x.shape[0]
    if b % (accum * count):
        raise ValueError(f"batch {b} not divisible by {accum} micro-batches x {count} ranks")
    n = b // (accum * count)
    return x.reshape((accum, count, n) + tuple(x.shape[1:]))[:, index].reshape(
        (accum * n,) + tuple(x.shape[1:]))

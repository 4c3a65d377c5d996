"""Tensor-parallel (Megatron) inference sharding of the DiT (port of
`bindyouravatar_tpu/parallel/tp.py`).

Each block's attention projections are split by heads: `to_q`, `to_k`,
`to_v` column-wise (`ColwiseParallel`: `Dense.weight` dim 0 and the bias),
`to_out` row-wise (`RowwiseParallel`: dim 1, then an all-reduce); the
feed-forward likewise (`net_0` column-wise, `net_2` row-wise).  The audio
cross-attention layers split the same way (their `to_out` carries a
per-query bias scale: its weight is split by hand and the partial products
all-reduced before the bias, `EinsumOutProj.tp_group`).  The attention
between them runs on local tensors with `heads / tp` heads per rank,
through the same kernels (B1 in the blocks, B3 in the audio layers), and
the activations are replicated at the block boundaries, as in JAX.

JAX's suffix rules (`_COL`/`_ROW`) let GSPMD split any column range; the
port's attention needs whole heads, so it splits only what keeps them:
  * a block whose `heads % tp != 0` (or whose feed-forward width does not
    divide, or that runs the chunked feed-forward `ff_chunked`, which takes
    the raw weights) keeps that module replicated;
  * the face modules, which JAX's suffix rules also match, stay
    replicated: a perceiver's q and k projections feed the router's norms
    over their whole width (`DiT._face_injection`), which a split by heads
    cannot keep, and the router's STAB attentions and the LFE are not split
    here (`ROADMAP.md` A12b);
  * the LoRA `to_q_lora_B`/`to_k_lora_B` [r, inner], which JAX leaves
    replicated, are split along the same columns as `to_q`/`to_k`, and the
    audio layers' `to_q`/`to_k`/`to_v` biases with their weights (JAX's
    rules name those biases only under `attn1`);
  * the QK LayerNorm's affine is per head dim and stays whole.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch.nn as nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Shard, distribute_tensor
from torch.distributed.tensor.parallel import ColwiseParallel, RowwiseParallel, parallelize_module

from .mesh import AXIS_TENSOR

_LORA_B = ("to_q_lora_B", "to_k_lora_B")


def tp_plan(model: nn.Module, tp_size: int) -> Dict[str, str]:
    """Module name -> "col" or "row": the blocks' modules that split by
    whole heads (attention) or evenly (feed-forward) over `tp_size` ranks."""
    plan = {}
    for i, layer in enumerate(getattr(model, "audio_layers", ())):
        if layer.heads % tp_size == 0:
            plan.update({f"audio_layers.{i}.{n}": "col" for n in ("to_q", "to_k", "to_v")})
            plan[f"audio_layers.{i}.to_out"] = "row"
    for i, blk in enumerate(model.blocks):
        a, ff = blk.attn1, blk.ff
        if a.heads % tp_size == 0:
            plan.update({f"blocks.{i}.attn1.{n}": "col" for n in ("to_q", "to_k", "to_v")})
            plan[f"blocks.{i}.attn1.to_out"] = "row"
        if ff.chunks == 1 and ff.net_0.out_features % tp_size == 0:
            plan[f"blocks.{i}.ff.net_0"] = "col"
            plan[f"blocks.{i}.ff.net_2"] = "row"
    return plan


def tp_specs(model: nn.Module, tp_size: int) -> Dict[str, Optional[int]]:
    """Parameter name -> the dim split over the tp ranks, or None
    (replicated); every parameter is replicated at `tp_size <= 1`, as in
    JAX."""
    plan = tp_plan(model, tp_size) if tp_size > 1 else {}
    specs = {}
    for name, _ in model.named_parameters():
        mod, _, leaf = name.rpartition(".")
        kind = plan.get(mod)
        dim = None
        if kind == "col":
            dim = 0
        elif kind == "row" and leaf == "weight":
            dim = 1
        elif leaf in _LORA_B and plan.get(f"{mod}.{leaf[:4]}") == "col":
            dim = 1
        specs[name] = dim
    return specs


def shard_params_tp(model: nn.Module, mesh: DeviceMesh) -> nn.Module:
    """Split `model`'s planned modules over the mesh's tp axis in place
    (the weights must be loaded first) and give each planned attention its
    local head count.  On a tp axis of size 1 the same modules are wrapped,
    each split spanning the one rank."""
    tp_mesh = mesh[AXIS_TENSOR] if mesh.mesh_dim_names and AXIS_TENSOR in mesh.mesh_dim_names \
        else mesh
    tp = tp_mesh.size()
    plan = tp_plan(model, tp)
    styles = {n: ColwiseParallel() if k == "col" else RowwiseParallel() for n, k in plan.items()
              if not n.startswith("audio_layers.") or k == "col"}
    parallelize_module(model, tp_mesh, styles)
    for i, layer in enumerate(getattr(model, "audio_layers", ())):
        if plan.get(f"audio_layers.{i}.to_out") != "row":
            continue
        layer.heads //= tp
        out = layer.to_out
        local = distribute_tensor(out.weight.detach(), tp_mesh, [Shard(1)]).to_local()
        out.weight = nn.Parameter(local.contiguous(), requires_grad=out.weight.requires_grad)
        out.tp_group = tp_mesh.get_group()
    for i, blk in enumerate(model.blocks):
        a = blk.attn1
        if plan.get(f"blocks.{i}.attn1.to_q") != "col":
            continue
        a.heads //= tp
        for leaf in _LORA_B:
            p = getattr(a, leaf, None)
            if p is not None:
                local = distribute_tensor(p.detach(), tp_mesh, [Shard(1)]).to_local()
                setattr(a, leaf, nn.Parameter(local.contiguous(), requires_grad=p.requires_grad))
    return model

"""Flax parameter tree (as numpy) -> the port's `state_dict`.

The JAX importers stay the only way in from reference checkpoints
(importer -> flax tree -> this converter).  Rules:
  * Dense `kernel` [in, out] -> `weight` [out, in]; conv `kernel`
    [kt, kh, kw, in, out] -> `weight` [out, in, kt, kh, kw];
  * LayerNorm / GroupNorm `scale` -> `weight`, `bias` -> `bias` (this covers
    the fused-QK-norm `_Affine` `norm_q`/`norm_k` params, whose tree is the
    LayerNorm's);
  * the audio projection's `conv_w` [2C, C] / `conv_b` -> `conv.weight`
    [C, 2C] / `conv.bias`;
  * the scan-stacked `blocks`, `audio_layers`, `perceiver` and
    `router_layers` [L, ...] leaves -> one module per layer, `blocks.{i}.`,
    `audio_layers.{i}.`, `perceivers.{i}.`, `router_layers.{i}.`;
  * the trunk's `final_proj` kernel [d, 1] is a Dense kernel -> [1, d];
  * the LFE's raw params `latents` [1, Q, dim] and `proj_out` [dim, out]
    are not Dense kernels and keep the JAX orientation, as do the LoRA
    leaves `to_q_lora_A` [dim, r] / `to_q_lora_B` [r, inner] (and to_k's):
    the port computes (x A) B as the flax module does.
Takes numpy arrays (e.g. `jax.tree.map(np.asarray, params)`); never jax.
`jax_train_state_to_torch` carries a JAX train state (trainable params,
AdamW moments and count, step, EMA) across the same way.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

# scan-stacked subtrees -> the port's ModuleList names
_STACKED = {"blocks": "blocks", "audio_layers": "audio_layers", "perceiver": "perceivers",
            "router_layers": "router_layers"}


def _leaf(path: tuple, arr: np.ndarray):
    *parents, name = path
    if name == "kernel":
        arr = arr.T if arr.ndim == 2 else arr.transpose(4, 3, 0, 1, 2)
        name = "weight"
    elif name == "scale":
        name = "weight"
    elif name == "conv_w":
        parents, name, arr = parents + ["conv"], "weight", arr.T
    elif name == "conv_b":
        parents, name = parents + ["conv"], "bias"
    return ".".join(parents + [name]), arr


def _walk(tree: Mapping[str, Any], prefix: tuple, out: Dict[str, np.ndarray]) -> None:
    for key, sub in tree.items():
        path = prefix + (str(key),)
        if isinstance(sub, Mapping):
            _walk(sub, path, out)
        else:
            name, arr = _leaf(path, np.asarray(sub))
            out[name] = arr


def _layer(tree: Mapping[str, Any], i: int) -> Dict[str, Any]:
    """Layer i of a scan-stacked subtree."""
    return {k: _layer(v, i) if isinstance(v, Mapping) else np.asarray(v)[i]
            for k, v in tree.items()}


def _num_layers(tree: Mapping[str, Any]) -> int:
    leaf = next(iter(tree.values()))
    return _num_layers(leaf) if isinstance(leaf, Mapping) else np.asarray(leaf).shape[0]


def jax_params_to_torch(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Convert a (numpy) flax param tree of `DiT.init` or `CausalVAE.init`."""
    flat: Dict[str, np.ndarray] = {}
    for top, sub in params.items():
        if top in _STACKED:
            for i in range(_num_layers(sub)):
                _walk(_layer(sub, i), (_STACKED[top], str(i)), flat)
        elif isinstance(sub, Mapping):
            _walk(sub, (top,), flat)
        else:
            flat[top] = np.asarray(sub)
    return {k: torch.from_numpy(np.array(v)) for k, v in flat.items()}


def check_trainable_set(jax_trainable: Mapping[str, Any],
                        torch_trainable: Mapping[str, torch.Tensor]) -> None:
    """Raise unless the port's trainable parameters (name -> tensor) are
    the converted image of the JAX trainable partition (the flax subtree
    `partition_params` returns): the same names, the same element counts."""
    want = {k: v.numel() for k, v in jax_params_to_torch(jax_trainable).items()}
    got = {k: v.numel() for k, v in torch_trainable.items()}
    if want != got:
        missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
        sizes = sorted(k for k in set(want) & set(got) if want[k] != got[k])
        raise ValueError(f"trainable sets differ: missing {missing[:5]}, extra {extra[:5]}, "
                         f"sizes {sizes[:5]}")


def jax_train_state_to_torch(params: Mapping[str, Any], mu: Mapping[str, Any],
                             nu: Mapping[str, Any], count: int, step: int,
                             ema_params: Optional[Mapping[str, Any]] = None):
    """A JAX `TrainState` (as numpy: the trainable params, AdamW's `mu`,
    `nu` and `count`, the step, the EMA params or None) -> (the trainable
    tensors by the port's names, the port's `TrainState`).  The moments
    have the params' tree, so `jax_params_to_torch`'s rules convert them
    too.  Copy the tensors into the trainer's `trainable` to continue a JAX
    fine-tune in the port."""
    from .training.trainer import TrainState

    return jax_params_to_torch(params), TrainState(
        step=int(step), count=int(count), mu=jax_params_to_torch(mu), nu=jax_params_to_torch(nu),
        ema=None if ema_params is None else jax_params_to_torch(ema_params))

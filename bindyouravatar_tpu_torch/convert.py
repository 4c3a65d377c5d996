"""Flax parameter tree (as numpy) -> the port's `state_dict`.

The JAX importers stay the only way in from reference checkpoints
(importer -> flax tree -> this converter).  Rules:
  * Dense `kernel` [in, out] -> `weight` [out, in]; conv `kernel`
    [kt, kh, kw, in, out] -> `weight` [out, in, kt, kh, kw] ([kh, kw, in,
    out] -> [out, in, kh, kw] in 2-D);
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
The same rules take `T5TextEncoder.init` and `EVACLIPVision.init`, whose
names the port keeps (`token_embedding`, `relative_attention_bias`,
`cls_token` and `pos_embed` are raw params and stay as they are).  The
face stack's networks (`ArcFaceEmbedder`, `RetinaFace`, `BiSeNet`) keep the
reference checkpoints' names instead: `jax_face_net_to_torch` undoes the
JAX importers' renames and reshapes.
`jax_sam2_to_torch` and `jax_rrdbnet_to_torch` do the same for SAM2
(sam2.1's names) and RRDBNet (Real-ESRGAN's).
Takes numpy arrays (e.g. `jax.tree.map(np.asarray, params)`); never jax.
`jax_train_state_to_torch` carries a JAX train state (trainable params,
AdamW moments and count, step, EMA) across the same way.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

# scan-stacked subtrees -> the port's ModuleList names
_STACKED = {"blocks": "blocks", "audio_layers": "audio_layers", "perceiver": "perceivers",
            "router_layers": "router_layers"}


def _leaf(path: tuple, arr: np.ndarray):
    *parents, name = path
    if name == "kernel":
        arr = {2: lambda a: a.T, 4: lambda a: a.transpose(3, 2, 0, 1),
               5: lambda a: a.transpose(4, 3, 0, 1, 2)}[arr.ndim](arr)
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


# the JAX importers' names -> the reference checkpoints' (`preprocess/*.py`)
_BN_LEAVES = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}
_FACE_RENAMES = {
    "common": [(r"layer(\d)_(\d+)", r"layer\1.\2"), (r"downsample_conv", "downsample.0"),
               (r"downsample_bn", "downsample.1")],
    "arcface": [(r"^prelu1\.", "prelu.")],
    "retinaface": [(r"^(fpn|ssh\d)\.(\w+)\.conv\.", r"\1.\2.0."),
                   (r"^(fpn|ssh\d)\.(\w+)\.bn\.", r"\1.\2.1."),
                   (r"^(BboxHead|ClassHead|LandmarkHead)_(\d)\.", r"\1.\2.conv1x1.")],
    "bisenet": [],
}


def jax_face_net_to_torch(params: Mapping[str, Any], net: str) -> Dict[str, torch.Tensor]:
    """A (numpy) flax tree of `ArcFaceEmbedder.init` (`net="arcface"`),
    `RetinaFace` (`"retinaface"`) or `BiSeNet` (`"bisenet"`) -> the port's
    `state_dict` under the reference checkpoint's names: conv kernels to
    [out, in, kh, kw], Dense kernels transposed, BN `scale`/`bias`/`mean`/
    `var` to `weight`/`bias`/`running_mean`/`running_var`, PReLU `alpha` to
    `weight`, `layer1_0` to `layer1.0`, and ArcFace's fc rows from JAX's
    NHWC flatten back to the NCHW flatten the reference's fc reads."""
    flat: Dict[str, np.ndarray] = {}

    def walk(tree, prefix):
        for key, sub in tree.items():
            path = prefix + (str(key),)
            if isinstance(sub, Mapping):
                walk(sub, path)
                continue
            *parents, name = path
            arr = np.asarray(sub)
            if name == "kernel":
                if net == "arcface" and parents == ["fc"]:
                    c, hw = 512, 7
                    arr = arr.reshape(hw, hw, c, -1).transpose(2, 0, 1, 3).reshape(c * hw * hw, -1)
                name, arr = "weight", arr.T if arr.ndim == 2 else arr.transpose(3, 2, 0, 1)
            else:
                name = "weight" if name == "alpha" else _BN_LEAVES.get(name, name)
            key = ".".join(parents + [name])
            for pat, rep in _FACE_RENAMES["common"] + _FACE_RENAMES[net]:
                key = re.sub(pat, rep, key)
            flat[key] = arr

    walk(params, ())
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


def _flat(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for key, sub in tree.items():
        path = f"{prefix}{key}"
        if isinstance(sub, Mapping):
            out.update(_flat(sub, path + "."))
        else:
            out[path] = np.asarray(sub)
    return out


def _torch_leaf(key: str, arr: np.ndarray):
    """A flax leaf -> (torch name, array): Dense kernels transposed, conv
    kernels [kh, kw, in, out] -> [out, in, kh, kw], LayerNorm `scale` ->
    `weight`."""
    parent, _, name = key.rpartition(".")
    if name == "kernel":
        return f"{parent}.weight", arr.T if arr.ndim == 2 else arr.transpose(3, 2, 0, 1)
    if name == "scale":
        return f"{parent}.weight", arr
    return key, arr


# the JAX SAM2 tree's names -> sam2.1's (`models/sam2.py`); the
# mask_downsampler entries are numbered in `jax_sam2_to_torch`
_SAM2_RENAMES = [(r"blocks_(\d+)", r"blocks.\1"), (r"mlp_layers_(\d+)", r"mlp.layers.\1"),
                 (r"(^|\.)layers_(\d+)", r"\1layers.\2"),
                 (r"neck\.convs_(\d+)", r"neck.convs.\1.conv"),
                 (r"output_upscaling_0", "output_upscaling.0"),
                 (r"output_upscaling_ln", "output_upscaling.1"),
                 (r"output_upscaling_3", "output_upscaling.3"),
                 (r"output_hypernetworks_mlps_(\d+)", r"output_hypernetworks_mlps.\1"),
                 (r"fuser_layers_(\d+)", r"fuser.layers.\1"),
                 (r"trunk\.patch_embed\.", "trunk.patch_embed.proj."),
                 (r"^conv_s([01])\.", r"sam_mask_decoder.conv_s\1.")]


def jax_sam2_to_torch(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A (numpy) flax tree of the JAX `SAM2Model` -> the port's
    `SAM2Model.state_dict()` under sam2.1's names: Dense kernels
    transposed, conv (and the decoder's transposed-conv) kernels to [out,
    in, kh, kw], the trunk's NHWC position embeddings to NCHW, the prompt
    encoder's and decoder's raw embeddings to `nn.Embedding` rows, the
    mask downsampler's conv / LN pairs to `encoder.{3i, 3i + 1}` and its
    final conv to `encoder.{3n}`, `maskmem_tpos_enc` to [n, 1, 1, mem_dim]."""
    flat = _flat(params.get("params", params))
    n_down = sum(1 for k in flat if re.search(r"mask_downsampler_ln_\d+\.bias$", k))
    out: Dict[str, np.ndarray] = {}
    for key, arr in flat.items():
        if key.endswith(("trunk.pos_embed", "trunk.pos_embed_window")):
            out[key] = arr.transpose(0, 3, 1, 2)
            continue
        if key == "sam_prompt_encoder.pe_gaussian":
            out["sam_prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"] = arr
            continue
        if key == "sam_prompt_encoder.point_embeddings":
            for i, row in enumerate(arr):
                out[f"sam_prompt_encoder.point_embeddings.{i}.weight"] = row[None]
            continue
        if key in ("sam_prompt_encoder.not_a_point_embed", "sam_prompt_encoder.no_mask_embed",
                   "sam_mask_decoder.iou_token", "sam_mask_decoder.obj_score_token",
                   "sam_mask_decoder.mask_tokens"):
            out[f"{key}.weight"] = arr.reshape(-1, arr.shape[-1])
            continue
        if key == "maskmem_tpos_enc":
            out[key] = arr.reshape(arr.shape[0], 1, 1, arr.shape[-1])
            continue
        name, arr = _torch_leaf(key, arr)
        for pat, rep in _SAM2_RENAMES:
            name = re.sub(pat, rep, name)
        name = re.sub(r"mask_downsampler_ln_(\d+)",
                      lambda m: f"mask_downsampler.encoder.{3 * int(m.group(1)) + 1}", name)
        name = re.sub(r"mask_downsampler_(\d+)",
                      lambda m: f"mask_downsampler.encoder.{3 * int(m.group(1))}", name)
        name = name.replace("mask_downsampler_final", f"mask_downsampler.encoder.{3 * n_down}")
        out[name] = arr
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def jax_rrdbnet_to_torch(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A (numpy) flax tree of the JAX `RRDBNet` (with or without its
    "params" wrapper) -> the port's `RRDBNet.state_dict()` under
    Real-ESRGAN's names (`conv_first`, `body.{i}.rdb{m}.conv{k}`, ...)."""
    out = {}
    for key, arr in _flat(params.get("params", params)).items():
        name, arr = _torch_leaf(key, arr)
        out[re.sub(r"^body_(\d+)", r"body.\1", name)] = arr
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}

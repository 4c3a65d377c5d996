"""Reader of the CogVideoX causal 3D VAE's reference weights (diffusers
`AutoencoderKLCogVideoX`; JAX `training/import_encoders.py:127-226`).

diffusers' names map to the port's `CausalVAE` state dict; torch's conv
layout [out, in, kt, kh, kw] is the port's, and the down / upsamplers'
2-D convs [out, in, kh, kw] gain a length-1 temporal axis.  The encoders'
readers live with their models: T5's in `models/t5.py`
(`load_t5_encoder`, `t5_state_dict`), EVA-CLIP's in `models/eva_clip.py`.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple, Union

import torch

from .checkpoint import load_named, read_reference
from .import_submodules import load_pt


def vae_key_map(cfg) -> Dict[str, Tuple[str, str]]:
    """diffusers key -> (the port's name, kind): kind "conv3d" (same
    layout), "conv2d" (a temporal axis of 1 added) or "vec"."""
    m: Dict[str, Tuple[str, str]] = {}

    def conv(theirs: str, ours: str, kind: str = "conv3d") -> None:
        # CogVideoXCausalConv3d and the down / upsamplers wrap an inner `conv`
        m[f"{theirs}.conv.weight"] = (f"{ours}.conv.weight", kind)
        m[f"{theirs}.conv.bias"] = (f"{ours}.conv.bias", "vec")

    def gn(theirs: str, ours: str) -> None:
        m[f"{theirs}.weight"] = (f"{ours}.gn.weight", "vec")
        m[f"{theirs}.bias"] = (f"{ours}.gn.bias", "vec")

    def resnet(theirs: str, ours: str, spatial: bool, has_shortcut: bool) -> None:
        for norm in ("norm1", "norm2"):
            if spatial:
                gn(f"{theirs}.{norm}.norm_layer", f"{ours}.{norm}.norm_layer")
                conv(f"{theirs}.{norm}.conv_y", f"{ours}.{norm}.conv_y")
                conv(f"{theirs}.{norm}.conv_b", f"{ours}.{norm}.conv_b")
            else:
                gn(f"{theirs}.{norm}", f"{ours}.{norm}")
        conv(f"{theirs}.conv1", f"{ours}.conv1")
        conv(f"{theirs}.conv2", f"{ours}.conv2")
        if has_shortcut:
            conv(f"{theirs}.conv_shortcut", f"{ours}.conv_shortcut")

    chans = cfg.block_out_channels
    n = len(chans)
    conv("encoder.conv_in", "encoder.conv_in")
    prev = chans[0]
    for i, ch in enumerate(chans):
        for j in range(cfg.layers_per_block):
            resnet(f"encoder.down_blocks.{i}.resnets.{j}", f"encoder.down_{i}_res_{j}",
                   spatial=False, has_shortcut=(prev if j == 0 else ch) != ch)
        prev = ch
        if i < n - 1:
            conv(f"encoder.down_blocks.{i}.downsamplers.0", f"encoder.down_{i}_downsample",
                 kind="conv2d")
    for j in range(2):
        resnet(f"encoder.mid_block.resnets.{j}", f"encoder.mid_res_{j}", spatial=False,
               has_shortcut=False)
    gn("encoder.norm_out", "encoder.norm_out")
    conv("encoder.conv_out", "encoder.conv_out")

    rev = tuple(reversed(chans))
    conv("decoder.conv_in", "decoder.conv_in")
    for j in range(2):
        resnet(f"decoder.mid_block.resnets.{j}", f"decoder.mid_res_{j}", spatial=True,
               has_shortcut=False)
    prev = rev[0]
    for i, ch in enumerate(rev):
        for j in range(cfg.layers_per_block + 1):
            resnet(f"decoder.up_blocks.{i}.resnets.{j}", f"decoder.up_{i}_res_{j}",
                   spatial=True, has_shortcut=(prev if j == 0 else ch) != ch)
        prev = ch
        if i < n - 1:
            conv(f"decoder.up_blocks.{i}.upsamplers.0", f"decoder.up_{i}_upsample",
                 kind="conv2d")
    gn("decoder.norm_out.norm_layer", "decoder.norm_out.norm_layer")
    conv("decoder.norm_out.conv_y", "decoder.norm_out.conv_y")
    conv("decoder.norm_out.conv_b", "decoder.norm_out.conv_b")
    conv("decoder.conv_out", "decoder.conv_out")
    return m


def _read(sd_or_path) -> Dict[str, torch.Tensor]:
    if isinstance(sd_or_path, str) and not sd_or_path.endswith(".safetensors"):
        return {k: torch.as_tensor(v) for k, v in load_pt(sd_or_path).items()}
    return read_reference(sd_or_path)


def vae_state_dict(sd_or_path: Union[str, Mapping[str, object]], cfg) -> Dict[str, torch.Tensor]:
    """The reader: a diffusers `AutoencoderKLCogVideoX` state dict
    (`.safetensors`, a torch `.pt` / `.bin`, or in memory) -> the port's
    `CausalVAE` tensors for `cfg`.  As JAX's, it takes the convs' keys also
    without the inner `.conv.` (dicts saved without the wrapper)."""
    sd = _read(sd_or_path)
    out = {}
    for theirs, (ours, kind) in vae_key_map(cfg).items():
        w = sd[theirs if theirs in sd else theirs.replace(".conv.", ".")]
        out[ours] = w[:, :, None] if kind == "conv2d" else w
    return out


def import_vae(sd_or_path, vae) -> None:
    """Load a diffusers VAE state dict into `vae` in place, every tensor
    of the model from the file."""
    load_named(vae, vae_state_dict(sd_or_path, vae.cfg).items(),
               expect={k for k, _ in vae.named_parameters()}, source="VAE")

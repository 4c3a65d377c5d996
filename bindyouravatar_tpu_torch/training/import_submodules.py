"""Readers of the reference's conditioning sub-module files (the port's
counterpart of the JAX package's `training/import_submodules.py`).

The reference distributes `audio_modules.pt`, `face_modules.pt` and
`router_modules.pt` (torch state dicts, bf16 or fp32, saved by
`transformer.py:461-513` / `router.py:413-423`).  Each reader takes a
path (loaded with `torch.load(..., weights_only=True, mmap=True)`) or an
in-memory dict of tensors or numpy arrays and returns `{name: tensor}` in
the port's parameter names; `import_all_submodules` copies them into a
live DiT.  The port keeps torch's Linear [out, in], so only the layouts
that differ from the reference's change:
  * the audio Conv1d(k=2, s=2) [C, C, 2] -> `conv.weight` [C, 2C]
    (columns: tap 0's input channels, then tap 1's);
  * each perceiver's fused `to_kv` -> `to_k` / `to_v` rows;
  * the router's shared input norms and per-layer q/k projections: the
    reference flattens the perceiver's q/k d-major (f = d*H + h,
    `router.py:375-378`), the port h-major (f = h*dh + d), so the norms'
    affines and the projections' input columns are permuted once here, with
    the model's own router head count (JAX's `import_all_submodules` uses 16
    whatever the model, `ROADMAP.md` C4);
  * the router's `layer_merge.*` (dead code in the reference forward) and its
    `pos_emb` buffer (computed on the fly here) are not read.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, Mapping, Optional, Tuple, Union

import torch

from .checkpoint import SUBMODULE_KEYS, load_named

Source = Union[str, os.PathLike, Mapping[str, object]]
Pairs = Iterator[Tuple[str, torch.Tensor]]


def load_pt(sd_or_path: Source):
    """A `.pt` file's object (tensors memory-mapped on the CPU), or the
    given dict."""
    if isinstance(sd_or_path, (str, os.PathLike)):
        return torch.load(sd_or_path, map_location="cpu", weights_only=True, mmap=True)
    return sd_or_path


def _tensors(sd: Mapping[str, object]) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v) for k, v in sd.items()}


def _lin(sd, ours: str, theirs: str) -> Pairs:
    yield f"{ours}.weight", sd[f"{theirs}.weight"]
    if f"{theirs}.bias" in sd:
        yield f"{ours}.bias", sd[f"{theirs}.bias"]


def _ln(sd, ours: str, theirs: str) -> Pairs:
    yield f"{ours}.weight", sd[f"{theirs}.weight"]
    yield f"{ours}.bias", sd[f"{theirs}.bias"]


def _count(sd, prefix: str) -> int:
    return 1 + max(int(k[len(prefix):].split(".")[0]) for k in sd if k.startswith(prefix))


def import_audio_modules(sd_or_path: Source) -> Dict[str, torch.Tensor]:
    """audio_modules.pt -> the `audio_statics.` and `audio_layers.` tensors."""
    sd = _tensors(load_pt(sd_or_path))

    def pairs() -> Pairs:
        p, s = "audio_proj_model", "audio_statics.proj"
        for n in ("proj1", "proj2", "proj3"):
            yield from _lin(sd, f"{s}.{n}", f"{p}.{n}")
        yield from _ln(sd, f"{s}.norm", f"{p}.norm")
        w = sd[f"{p}.conv1.weight"]                                   # [C, C, 2]
        if w.ndim != 3 or w.shape[-1] != 2:
            raise ValueError(f"{p}.conv1.weight: {tuple(w.shape)}, want [C, C, 2]")
        yield f"{s}.conv.weight", torch.cat([w[:, :, 0], w[:, :, 1]], dim=1)
        yield f"{s}.conv.bias", sd[f"{p}.conv1.bias"]
        for n in ("mute_learnable_tokens", "learnable_scale"):
            yield f"audio_statics.{n}", sd[n]
        for i in range(_count(sd, "layers.")):
            ours, theirs = f"audio_layers.{i}", f"layers.{i}"
            yield from _ln(sd, f"{ours}.norm_q", f"{theirs}.norm_q")
            for n in ("to_q", "to_k", "to_v"):
                yield from _lin(sd, f"{ours}.{n}", f"{theirs}.attn.{n}")
            yield from _lin(sd, f"{ours}.to_out", f"{theirs}.attn.to_out.0")

    return dict(pairs())


def _mapping_mlp(sd, ours: str, theirs: str) -> Pairs:
    """torch Sequential(Linear, LN, LeakyReLU) x 2 + Linear -> `_MappingMLP`."""
    for mine, idx in (("fc0", 0), ("fc1", 3), ("fc_out", 6)):
        yield from _lin(sd, f"{ours}.{mine}", f"{theirs}.{idx}")
    for mine, idx in (("ln0", 1), ("ln1", 4)):
        yield from _ln(sd, f"{ours}.{mine}", f"{theirs}.{idx}")


def import_face_modules(sd_or_path: Source) -> Dict[str, torch.Tensor]:
    """face_modules.pt ({"local_facial_extractor": state dict,
    "perceiver_cross_attention": [state dict, ...]}) -> the `lfe.` and
    `perceivers.` tensors."""
    obj = load_pt(sd_or_path)
    lfe = _tensors(obj["local_facial_extractor"])
    pcas = [_tensors(sd) for sd in obj["perceiver_cross_attention"]]

    def pairs() -> Pairs:
        # the LFE's raw latents [1, Q, dim] and proj_out [dim, out] are not
        # Linear weights: the port keeps the reference's orientation
        yield "lfe.latents", lfe["latents"]
        yield "lfe.proj_out", lfe["proj_out"]
        yield from _mapping_mlp(lfe, "lfe.id_embedding_mapping", "id_embedding_mapping")
        for i in range(5):
            yield from _mapping_mlp(lfe, f"lfe.mapping_{i}", f"mapping_{i}")
        for i in range(_count(lfe, "layers.")):
            a, f = f"layers.{i}.0", f"layers.{i}.1"
            for n in ("norm1", "norm2"):
                yield from _ln(lfe, f"lfe.attn_{i}.{n}", f"{a}.{n}")
            for n in ("to_q", "to_kv", "to_out"):
                yield from _lin(lfe, f"lfe.attn_{i}.{n}", f"{a}.{n}")
            yield from _ln(lfe, f"lfe.ff_{i}.norm", f"{f}.0")
            yield from _lin(lfe, f"lfe.ff_{i}.fc1", f"{f}.1")
            yield from _lin(lfe, f"lfe.ff_{i}.fc2", f"{f}.3")
        for j, sd in enumerate(pcas):
            ours = f"perceivers.{j}"
            for n in ("norm1", "norm2"):
                yield from _ln(sd, f"{ours}.{n}", n)
            for n in ("to_q", "to_out"):
                yield from _lin(sd, f"{ours}.{n}", n)
            # the reference fuses k and v into one Linear (`router.py:223`)
            k, v = sd["to_kv.weight"].chunk(2, dim=0)
            yield f"{ours}.to_k.weight", k
            yield f"{ours}.to_v.weight", v

    return dict(pairs())


def _router_permutation(qk_dim: int, num_heads: int) -> torch.Tensor:
    """For each h-major feature f = h*dh + d, its d-major index d*H + h."""
    dh = qk_dim // num_heads
    f = torch.arange(qk_dim)
    return (f % dh) * num_heads + f // dh


def import_router_modules(sd_or_path: Source, num_heads: int) -> Dict[str, torch.Tensor]:
    """router_modules.pt -> the `router_norms.`, `router_layers.` and
    `router_trunk.` tensors, the q/k packing permuted for `num_heads`
    router heads (the model's `RouterConfig.num_heads`)."""
    sd = _tensors(load_pt(sd_or_path))
    perm = _router_permutation(sd["norm_q.weight"].shape[0], num_heads)

    def pairs() -> Pairs:
        for n in ("norm_q", "norm_k"):
            for leaf in ("weight", "bias"):
                yield f"router_norms.{n}.{leaf}", sd[f"{n}.{leaf}"][perm]
        for i in range(_count(sd, "to_q.")):
            for n in ("to_q", "to_k"):
                yield f"router_layers.{i}.{n}.weight", sd[f"{n}.{i}.weight"][:, perm]
        t = "router_trunk"
        yield from _ln(sd, f"{t}.norm", "norm")
        for i in range(_count(sd, "spatial_temporal_layers.")):
            ours, theirs = f"{t}.st_{i}", f"spatial_temporal_layers.{i}"
            for attn in ("spatial_attn", "temporal_attn", "multi_id_attn"):
                for n in ("to_q", "to_k", "to_v"):
                    yield from _lin(sd, f"{ours}.{attn}.{n}", f"{theirs}.{attn}.{n}")
                yield from _lin(sd, f"{ours}.{attn}.to_out", f"{theirs}.{attn}.to_out.0")
            for n in ("norm1", "norm2", "norm3", "norm4"):
                yield from _ln(sd, f"{ours}.{n}", f"{theirs}.{n}")
            yield from _lin(sd, f"{ours}.mlp_fc1", f"{theirs}.mlp.0")
            yield from _lin(sd, f"{ours}.mlp_fc2", f"{theirs}.mlp.2")
        yield from _lin(sd, f"{t}.final_proj", "final_proj.0")

    return dict(pairs())


def import_all_submodules(dit, *, audio: Optional[Source] = None, face: Optional[Source] = None,
                          router: Optional[Source] = None) -> None:
    """Load any subset of the reference sub-module files into `dit` in
    place, one tensor at a time in its dtype; each file must give every
    tensor of its group (`SUBMODULE_KEYS`) and nothing else."""
    readers = {"audio": (audio, import_audio_modules), "face": (face, import_face_modules),
               "router": (router, lambda s: import_router_modules(
                   s, dit.router_cfg.num_heads))}
    names = [k for k, _ in dit.named_parameters()]
    for group, (src, read) in readers.items():
        if src is None:
            continue
        expect = {k for k in names if k.startswith(SUBMODULE_KEYS[group])}
        load_named(dit, read(src).items(), expect=expect,
                   source=f"{group} modules {src if isinstance(src, str) else ''}".rstrip())

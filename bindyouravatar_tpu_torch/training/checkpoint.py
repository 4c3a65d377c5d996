"""Checkpoints of a training run in torch's own format (the port's
counterpart of the JAX package's orbax `training/checkpoint.py`).

* The train state: one directory per step, `{directory}/{step}/state.pt`,
  written under a temporary name and renamed when complete, so a crash in
  the middle of a save (the crash-restart monitor's case) leaves no
  unreadable latest step; `total_limit` keeps the newest N (orbax's
  `max_to_keep`).  Tensors load to the CPU memory-mapped, so a restore
  copies them into the live tensors one at a time.
* The audio / face / router sub-modules, `{directory}/{name}_modules.pt`,
  for inference to mix and match (the reference's `audio_modules.pt`,
  `face_modules.pt`, `router_modules.pt`).
* The reference's base transformer (`BindyouravatarTransformer3DModel`'s
  sharded safetensors, bf16 or fp32: `import_reference_dit`) and its peft
  LoRA files (`import_lora_safetensors`, `fuse_lora_files`, `fuse_lora`),
  read with `utils/safetensors.py` (JAX `training/checkpoint.py:105-350`).
  The readers return `{name: tensor}` in the port's names, the file's
  dtype, memory-mapped where no layout changes; the importers copy them into
  the live DiT one tensor at a time, in its dtype.  Linear weights keep
  torch's [out, in]; q/k output rows (and their biases) take the per-head
  RoPE interleave -> rotate-half permutation, the per-head QK-norm affines
  the head's, the patch embed's conv gains zero input channels up to the
  model's (`transformer.py:1061-1073`) and flattens in (C, p, p) order.
  The sub-module files' readers are in `import_submodules.py`.
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, Iterable, Iterator, List, Mapping, Optional, Sequence, Set, Tuple, Union

import torch

# name-prefix groups of the sub-module files, in the port's parameter names
SUBMODULE_KEYS = {
    "audio": ("audio_statics.", "audio_layers."),
    "face": ("lfe.", "perceivers."),
    "router": ("router_norms.", "router_layers.", "router_trunk."),
}

_STATE = "state.pt"


def _steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(n) for n in os.listdir(directory)
                  if n.isdigit() and os.path.isfile(os.path.join(directory, n, _STATE)))


def _save_file(obj, path: str) -> None:
    with open(path, "wb") as f:
        torch.save(obj, f)
        f.flush()
        os.fsync(f.fileno())


def _fsync_dir(directory: str) -> None:
    fd = os.open(directory, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save_checkpoint(directory: str, step: int, payload: Mapping[str, object],
                    total_limit: Optional[int] = None) -> str:
    """Write `payload` (tensors, numbers, strings and containers of them)
    as step `step`; then drop all but the newest `total_limit` steps.
    Returns the step's directory."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, str(step))
    tmp = os.path.join(directory, f".tmp-{step}-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    _save_file(dict(payload), os.path.join(tmp, _STATE))
    if os.path.isdir(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _fsync_dir(directory)
    if total_limit:
        for old in _steps(directory)[:-total_limit]:
            shutil.rmtree(os.path.join(directory, str(old)))
    return final


def latest_step(directory: str) -> Optional[int]:
    steps = _steps(directory)
    return steps[-1] if steps else None


def restore_checkpoint(directory: str, step: Optional[int] = None) -> Dict[str, object]:
    """The payload of `step` (default the latest), tensors on the CPU,
    memory-mapped from the file."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    return torch.load(os.path.join(directory, str(step), _STATE), map_location="cpu",
                      mmap=True, weights_only=True)


def checkpoint_bytes(path: str) -> int:
    """Bytes of the files under `path`."""
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def save_submodules(named: Mapping[str, torch.Tensor], directory: str) -> None:
    """Write each group of `SUBMODULE_KEYS` present in `named` (parameter
    name -> tensor) to `{directory}/{group}_modules.pt`."""
    os.makedirs(directory, exist_ok=True)
    for group, prefixes in SUBMODULE_KEYS.items():
        sub = {k: v.detach() for k, v in named.items() if k.startswith(prefixes)}
        if sub:
            path = os.path.join(directory, f"{group}_modules.pt")
            _save_file(sub, path + ".tmp")
            os.replace(path + ".tmp", path)


def load_submodules(module: torch.nn.Module, directory: str,
                    names: Optional[Iterable[str]] = None) -> Set[str]:
    """Load the saved groups (`names`, default all) of `directory` into
    `module` in place with `load_named`; a group without a file is skipped.
    Raises on a saved name the module lacks or a shape it does not have.
    Returns the names loaded."""
    seen: Set[str] = set()
    for group in names or list(SUBMODULE_KEYS):
        path = os.path.join(directory, f"{group}_modules.pt")
        if os.path.isfile(path):
            seen |= load_named(module, torch.load(path, map_location="cpu", mmap=True,
                                                  weights_only=True).items(), source=path)
    return seen


# ------------------------------------------------------------------ #
# reference-format weights
# ------------------------------------------------------------------ #

StateDict = Mapping[str, torch.Tensor]
Files = Union[str, Sequence[str], Mapping[str, object]]


def read_reference(files_or_sd: Files) -> Dict[str, torch.Tensor]:
    """A safetensors file, a list of shards, or an in-memory state dict
    (tensors or numpy arrays) -> {name: tensor} on the CPU."""
    from ..utils.safetensors import load_files

    if isinstance(files_or_sd, Mapping):
        return {k: torch.as_tensor(v) for k, v in files_or_sd.items()}
    return load_files([files_or_sd] if isinstance(files_or_sd, str) else files_or_sd)


@torch.no_grad()
def load_named(module: torch.nn.Module, tensors: Iterable[Tuple[str, torch.Tensor]],
               expect: Optional[Set[str]] = None, source: str = "") -> Set[str]:
    """Copy (name, tensor) pairs into `module`'s parameters and buffers one
    at a time, each cast to the live tensor's dtype and device.  Raises on
    a name the module lacks, a shape it does not have, and, with `expect`,
    unless the names given are exactly `expect`.  Returns the names."""
    live = dict(module.named_parameters())
    live.update(module.named_buffers())
    seen = set()
    for name, t in tensors:
        p = live.get(name)
        if p is None or p.shape != t.shape:
            have = "" if p is None else f", the model's is {tuple(p.shape)}"
            raise ValueError(f"{source}: {name} {tuple(t.shape)} does not fit the model{have}")
        p.copy_(t.to(p.device))         # moved in the file's dtype, cast on the device
        seen.add(name)
    if expect is not None and seen != expect:
        raise ValueError(f"{source}: missing {sorted(expect - seen)[:5]}, "
                         f"unexpected {sorted(seen - expect)[:5]}")
    return seen


def _rope_permutation(head_dim: int) -> torch.Tensor:
    """Interleaved pair layout -> rotate-half layout (`ops/rope.py`)."""
    return torch.cat([torch.arange(0, head_dim, 2), torch.arange(1, head_dim, 2)])


def _head_permutation(heads: int, head_dim: int) -> torch.Tensor:
    perm = _rope_permutation(head_dim)
    return torch.cat([perm + h * head_dim for h in range(heads)])


def _lora_name(name: str) -> bool:
    return "_lora_" in name


def base_names(dit) -> Set[str]:
    """The DiT's base transformer: every parameter but the conditioning
    modules' (`SUBMODULE_KEYS`), the LoRA slots and the 2B variant's fixed
    sincos `pos_embedding` (diffusers keeps it out of the state dict)."""
    groups = tuple(p for ps in SUBMODULE_KEYS.values() for p in ps)
    return {k for k, _ in dit.named_parameters()
            if not k.startswith(groups) and not _lora_name(k) and k != "pos_embedding"}


def _dit_tensors(sd: StateDict, cfg) -> Iterator[Tuple[str, torch.Tensor]]:
    full = _head_permutation(cfg.num_attention_heads, cfg.attention_head_dim)
    perm = _rope_permutation(cfg.attention_head_dim)

    def same(ours: str, theirs: str, bias: bool = True):
        yield f"{ours}.weight", sd[f"{theirs}.weight"]
        if bias:
            yield f"{ours}.bias", sd[f"{theirs}.bias"]

    pw = sd["patch_embed.proj.weight"]                    # [dim, C, p, p]
    if pw.shape[1] < cfg.in_channels:       # channel growth: the new channels are zero
        grown = pw.new_zeros((pw.shape[0], cfg.in_channels) + tuple(pw.shape[2:]))
        grown[:, :pw.shape[1]] = pw
        pw = grown
    yield "patch_embed.proj.weight", pw.reshape(pw.shape[0], -1)
    yield "patch_embed.proj.bias", sd["patch_embed.proj.bias"]
    yield from same("patch_embed.text_proj", "patch_embed.text_proj")
    for n in ("linear_1", "linear_2"):
        yield from same(f"time_embedding.{n}", f"time_embedding.{n}")
    for i in range(cfg.num_layers):
        ours, theirs = f"blocks.{i}", f"transformer_blocks.{i}"
        for norm in ("norm1", "norm2"):
            yield from same(f"{ours}.{norm}.linear", f"{theirs}.{norm}.linear")
            yield from same(f"{ours}.{norm}.norm", f"{theirs}.{norm}.norm")
        for proj in ("to_q", "to_k"):
            for leaf in ("weight", "bias"):
                yield f"{ours}.attn1.{proj}.{leaf}", sd[f"{theirs}.attn1.{proj}.{leaf}"][full]
        yield from same(f"{ours}.attn1.to_v", f"{theirs}.attn1.to_v")
        for norm in ("norm_q", "norm_k"):
            for leaf in ("weight", "bias"):
                yield f"{ours}.attn1.{norm}.{leaf}", sd[f"{theirs}.attn1.{norm}.{leaf}"][perm]
        yield from same(f"{ours}.attn1.to_out", f"{theirs}.attn1.to_out.0")
        yield from same(f"{ours}.ff.net_0", f"{theirs}.ff.net.0.proj")
        yield from same(f"{ours}.ff.net_2", f"{theirs}.ff.net.2")
    yield from same("norm_final", "norm_final")
    yield from same("norm_out.linear", "norm_out.linear")
    yield from same("norm_out.norm", "norm_out.norm")
    yield from same("proj_out", "proj_out")


def reference_dit_state_dict(files_or_sd: Files, cfg) -> Dict[str, torch.Tensor]:
    """The reader: a reference `BindyouravatarTransformer3DModel` state dict
    (safetensors shards or in memory) -> the base transformer's tensors by
    the port's names for a DiT of `cfg` (JAX `import_reference_dit`
    followed by `convert.jax_params_to_torch`, without the init's
    conditioning modules).  A key the DiT reads that the file lacks raises
    `KeyError`; keys it does not read are ignored."""
    return dict(_dit_tensors(read_reference(files_or_sd), cfg))


def import_reference_dit(files_or_sd: Files, dit) -> None:
    """Load the reference base transformer into `dit` in place (JAX
    `training/checkpoint.py:111-222`); its conditioning modules and LoRA
    slots keep their values."""
    sd = read_reference(files_or_sd)
    load_named(dit, _dit_tensors(sd, dit.cfg), expect=base_names(dit),
               source="reference transformer")


def _peft_lora(files_or_sd: Files, cfg) -> Iterator[Tuple[int, str, torch.Tensor, torch.Tensor]]:
    """(layer, "to_q" / "to_k", A [r, in], B [out, r] with the RoPE
    permutation on its rows) of a peft LoRA file, whose keys are
    `[transformer.][module.]transformer_blocks.{i}.attn1.to_{q,k}.lora_{A,B}.weight`."""
    sd = {}
    for k, v in read_reference(files_or_sd).items():
        i = k.find("transformer_blocks.")
        sd[k[i:] if i >= 0 else k] = v
    full = _head_permutation(cfg.num_attention_heads, cfg.attention_head_dim)
    for i in range(cfg.num_layers):
        for proj in ("to_q", "to_k"):
            base = f"transformer_blocks.{i}.attn1.{proj}"
            yield i, proj, sd[f"{base}.lora_A.weight"], sd[f"{base}.lora_B.weight"][full]


def lora_state_dict(files_or_sd: Files, cfg) -> Dict[str, torch.Tensor]:
    """The reader: peft LoRA files -> the DiT's LoRA slots by the port's
    names, in JAX's orientation (`convert.py`): `to_q_lora_A` [in, r],
    `to_q_lora_B` [r, out] (JAX `_parse_lora_stacked`)."""
    out = {}
    for i, proj, a, b in _peft_lora(files_or_sd, cfg):
        out[f"blocks.{i}.attn1.{proj}_lora_A"] = a.t()
        out[f"blocks.{i}.attn1.{proj}_lora_B"] = b.t()
    return out


def import_lora_safetensors(files_or_sd: Files, dit) -> None:
    """Load peft LoRA files into the DiT's LoRA slots (reference
    `load_mixed_lora_weights`, `util/utils.py:1027-1048`); a DiT without
    slots or of another rank raises.  peft's alpha / r scaling is the
    port's, so the values load raw."""
    if dit.cfg.lora_rank <= 0:
        raise ValueError("DiT config has lora_rank=0 — no LoRA slots to fill "
                         "(use fuse_lora_files for inference configs)")
    live = dict(dit.named_parameters())
    sd = lora_state_dict(files_or_sd, dit.cfg)
    for name, t in sd.items():
        if live[name].shape != t.shape:
            raise ValueError(f"{name}: expected {tuple(live[name].shape)}, got {tuple(t.shape)} "
                             f"(rank mismatch?)")
    load_named(dit, sd.items(), expect={k for k in live if _lora_name(k)}, source="LoRA")


@torch.no_grad()
def _fold(weight: torch.Tensor, a: torch.Tensor, b: torch.Tensor, lora_alpha: float) -> None:
    """weight [out, in] += (b [out, r] @ a [r, in]) * alpha / r, summed in
    fp32 and cast back to the weight's dtype."""
    dev = weight.device
    delta = b.to(dev, torch.float32) @ a.to(dev, torch.float32)
    weight.copy_((weight.float() + delta * (lora_alpha / a.shape[0])).to(weight.dtype))


def fuse_lora_files(files_or_sd: Files, dit, lora_alpha: float = 128.0) -> None:
    """Fold peft LoRA files straight into the DiT's base q/k weights in place
    (the reference's load + `pipe.fuse_lora()`, `infer.py:199, 279`); the
    inference path, for a DiT built with `lora_rank=0`."""
    live = dict(dit.named_parameters())
    for i, proj, a, b in _peft_lora(files_or_sd, dit.cfg):
        _fold(live[f"blocks.{i}.attn1.{proj}.weight"], a, b, lora_alpha)


def fuse_lora(named: StateDict, lora_alpha: float = 128.0) -> Dict[str, torch.Tensor]:
    """`named` (a DiT's state dict) with each layer's LoRA delta folded into
    its base q/k weight and the LoRA slots dropped (the reference's
    `pipe.fuse_lora()`): what a DiT built with `lora_rank=0` loads."""
    out = {k: v for k, v in named.items() if not _lora_name(k)}
    for k, a in named.items():
        if k.endswith("_lora_A"):
            base = k[:-len("_lora_A")]
            w = out[f"{base}.weight"] = out[f"{base}.weight"].clone()
            _fold(w, a.t().contiguous(), named[f"{base}_lora_B"].t().contiguous(), lora_alpha)
    return out

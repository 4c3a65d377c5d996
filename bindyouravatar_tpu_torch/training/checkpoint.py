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

The reference-safetensors importers stay in the JAX package: a reference
checkpoint comes in through them and `convert.py`.
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, Iterable, List, Mapping, Optional

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


def load_submodules(named: Mapping[str, torch.Tensor], directory: str,
                    names: Optional[Iterable[str]] = None) -> Dict[str, torch.Tensor]:
    """`named` with the saved groups' tensors in place of its own (a new
    dict; each saved tensor takes the dtype and device of the one it
    replaces).  Raises on a saved name `named` lacks or a shape it does not
    have."""
    out = dict(named)
    for group in names or list(SUBMODULE_KEYS):
        path = os.path.join(directory, f"{group}_modules.pt")
        if not os.path.isfile(path):
            continue
        for k, v in torch.load(path, map_location="cpu", weights_only=True).items():
            if k not in out or out[k].shape != v.shape:
                raise ValueError(f"{path}: {k} {tuple(v.shape)} does not fit the model")
            out[k] = v.to(dtype=out[k].dtype, device=out[k].device)
    return out

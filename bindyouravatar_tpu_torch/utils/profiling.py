"""Profiling / tracing hooks (port of `bindyouravatar_tpu/utils/profiling.py`).

`trace(dir)` wraps a region in a `torch.profiler` trace (the CPU, plus the
GPU's kernels when one is present) written by `tensorboard_trace_handler`
(viewable in TensorBoard / Perfetto); `PhaseTimer` collects named
wall-clock phases, each ended by `sync` (one scalar fetched from the
device, which waits for the work queued before it).
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Any, Dict, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def _first_tensor(x) -> Optional[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for v in x:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def sync(x) -> None:
    """Force completion of a device value (fetch one scalar of the first
    tensor in `x`, a tensor or a nest of lists, tuples and dicts)."""
    t = _first_tensor(x)
    if t is not None:
        t.reshape(-1)[0].item()


class PhaseTimer:
    """Named phase timing; `report()` -> dict of seconds."""

    def __init__(self):
        self.phases: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync_value: Optional[Any] = None):
        t0 = time.perf_counter()
        holder = {}
        try:
            yield holder
        finally:
            v = holder.get("value", sync_value)
            if v is not None:
                sync(v)
            self.phases[name] = self.phases.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> Dict[str, float]:
        return dict(self.phases)

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.report(), f, indent=2)

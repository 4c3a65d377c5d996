"""The port's profiling helpers (`utils/profiling.py`) against the JAX
package's, on the CPU: `PhaseTimer` with `time.perf_counter` replaced by
the same clock in both modules gives the same `report()` and the same
`dump` text; `sync` on a CPU tensor (and on a nest of them); a CPU `trace`
writes a trace file."""

import glob
import itertools
import json
import os

import jax.numpy as jnp
import pytest
import torch

from bindyouravatar_tpu.utils import profiling as jprof
from bindyouravatar_tpu_torch.utils import profiling as tprof


def _run(mod, value, monkeypatch, path):
    clock = itertools.count(start=1.0, step=0.25)
    monkeypatch.setattr(mod.time, "perf_counter", lambda: next(clock))
    timer = mod.PhaseTimer()
    with timer.phase("encode"):
        pass
    with timer.phase("denoise", sync_value=value):
        pass
    with timer.phase("encode") as h:
        h["value"] = value
    timer.dump(path)
    with open(path) as f:
        return timer.report(), f.read()


def test_phase_timer_matches_jax(monkeypatch, tmp_path):
    got = _run(tprof, torch.ones(3), monkeypatch, str(tmp_path / "t.json"))
    want = _run(jprof, jnp.ones(3), monkeypatch, str(tmp_path / "j.json"))
    assert got == want
    assert json.loads(got[1]) == {"encode": 0.5, "denoise": 0.25}


@pytest.mark.parametrize("value", [torch.arange(6.0).reshape(2, 3),
                                   {"a": [torch.zeros(2, 2), 1.0]}, (3, torch.ones(1)),
                                   "no tensor"])
def test_sync_takes_tensors_and_nests(value):
    tprof.sync(value)


def test_cpu_trace_writes_a_trace_file(tmp_path):
    with tprof.trace(str(tmp_path)):
        torch.randn(64, 64) @ torch.randn(64, 64)
    files = glob.glob(os.path.join(str(tmp_path), "*.json"))
    assert files
    with open(files[0]) as f:
        assert "aten::mm" in f.read()

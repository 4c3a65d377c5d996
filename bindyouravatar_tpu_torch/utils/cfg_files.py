"""`.cfg` batch-config front end: the port's copy of the JAX package's
`utils/cfg_files.py` (reference `tools/batch_run_samples.py:10-43`).

Each cfg file holds shell-token lines (`--flag value ...`, `#` comments); a
sample cfg is merged over `default.cfg` (the sample wins flag by flag), then
lexed into an argv for the inference CLI, as the reference's
`assets/config/{default,NNN}.cfg`.
"""

from __future__ import annotations

import shlex
from typing import Dict, List


def parse_cfg(path: str) -> Dict[str, List[str]]:
    """cfg file -> {flag: [values...]}, multi-value flags kept."""
    tokens: List[str] = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if line:
                tokens.extend(shlex.split(line))
    out: Dict[str, List[str]] = {}
    cur = None
    for t in tokens:
        if t.startswith("--"):
            cur = t
            out.setdefault(cur, [])
        elif cur is not None:
            out[cur].append(t)
    return out


def merge_cfgs(default: Dict[str, List[str]],
               override: Dict[str, List[str]]) -> Dict[str, List[str]]:
    merged = {k: list(v) for k, v in default.items()}
    for k, v in override.items():
        merged[k] = list(v)
    return merged


def cfg_to_argv(cfg: Dict[str, List[str]]) -> List[str]:
    argv: List[str] = []
    for k, v in cfg.items():
        argv.append(k)
        argv.extend(v)
    return argv


def load_merged_argv(default_path: str, sample_path: str) -> List[str]:
    return cfg_to_argv(merge_cfgs(parse_cfg(default_path), parse_cfg(sample_path)))

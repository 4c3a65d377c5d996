"""Batch inference driver (the port's copy of the root
`tools/batch_run_samples.py`):

    python -m bindyouravatar_tpu_torch.tools.batch_run_samples \\
        [--config_dir assets/config] [--samples 000.cfg 005.cfg] \\
        [--output_root output/batch] [--device cpu] [--subprocess]

Merges `default.cfg` with each sample `NNN.cfg` (`utils/cfg_files.py`),
adds `--output_dir {output_root}/NNN` and `--device`, and runs the port's
inference CLI once per sample: in this process by default
(`bindyouravatar_tpu_torch.infer.main`), or with `--subprocess` as
`python -m bindyouravatar_tpu_torch.infer` per sample.  Paths in the cfg
files are relative to the working directory (the repo's root for
`assets/config`).  The exit code is the largest of the samples'.
"""

from __future__ import annotations

import argparse
import glob
import os
import subprocess
import sys
import traceback
from typing import List, Optional, Sequence, Tuple

from ..utils.cfg_files import load_merged_argv

PACKAGE_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _exit_code(e: SystemExit, name: str) -> int:
    # SystemExit.code may be a message (argparse and usage errors): any
    # code that is not an int or None is a failure
    if e.code is None or isinstance(e.code, int):
        return int(e.code or 0)
    print(f"[batch] {name}: {e.code}", file=sys.stderr)
    return 1


def run_sample(argv: List[str], name: str, in_subprocess: bool) -> int:
    if in_subprocess:
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(p for p in (PACKAGE_PARENT,
                                                        env.get("PYTHONPATH")) if p)
        return subprocess.run([sys.executable, "-m", "bindyouravatar_tpu_torch.infer"] + argv,
                              env=env).returncode
    from .. import infer

    try:
        infer.main(argv)
        return 0
    except SystemExit as e:
        return _exit_code(e, name)
    except Exception:     # the sample fails, the batch goes on and exits non-zero
        traceback.print_exc()
        return 1


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config_dir", default="assets/config")
    p.add_argument("--default_cfg", default=None)
    p.add_argument("--samples", nargs="*", default=None,
                   help="sample cfg names (default: every NNN.cfg)")
    p.add_argument("--output_root", default="output/batch")
    p.add_argument("--device", default="cuda", help="the card unless 'cpu' is asked for")
    p.add_argument("--subprocess", action="store_true")
    args = p.parse_args(argv)

    default_cfg = args.default_cfg or os.path.join(args.config_dir, "default.cfg")
    samples = args.samples or sorted(
        os.path.basename(f) for f in glob.glob(os.path.join(args.config_dir, "*.cfg"))
        if os.path.basename(f) != "default.cfg")
    results: List[Tuple[str, int]] = []
    for name in samples:
        sample_argv = load_merged_argv(default_cfg, os.path.join(args.config_dir, name))
        out_dir = os.path.join(args.output_root, os.path.splitext(name)[0])
        sample_argv += ["--output_dir", out_dir, "--device", args.device]
        print(f"[batch] {name} -> {out_dir}", flush=True)
        results.append((name, run_sample(sample_argv, name, args.subprocess)))
    for name, rc in results:
        print(f"[batch] {name}: {'OK' if rc == 0 else f'FAIL({rc})'}")
    return max((rc for _, rc in results), default=0)


if __name__ == "__main__":
    sys.exit(main())

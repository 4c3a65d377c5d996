"""The port's `.cfg` front end and batch driver on the CPU.

`parse_cfg`, `merge_cfgs` (over `default.cfg`), `cfg_to_argv` and
`load_merged_argv` equal the JAX package's on every file of
`assets/config/`, and the merged argv parses in the port's CLI.  The batch
driver (`python -m bindyouravatar_tpu_torch.tools.batch_run_samples`) runs
the golden sample 005 (two speakers, `--two_stage_generate`) end to end in
this process with `--device cpu` (the golden tier: `--model_size tiny`, 2
steps, 9 frames at 128 x 192); its exit code is the largest of the
samples', and `--subprocess` runs `python -m bindyouravatar_tpu_torch.infer`
per sample.
"""

import glob
import os
import subprocess
import sys

import pytest

from bindyouravatar_tpu.utils import cfg_files as jcfg
from bindyouravatar_tpu_torch import infer
from bindyouravatar_tpu_torch.tools import batch_run_samples as batch
from bindyouravatar_tpu_torch.utils import cfg_files as tcfg
from torch_port_utils import threads_per_worker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "assets", "config")
CFGS = sorted(os.path.basename(p) for p in glob.glob(os.path.join(CONFIG, "*.cfg")))


@pytest.fixture(autouse=True, scope="module")
def _threads():
    with threads_per_worker():
        yield


@pytest.mark.parametrize("name", CFGS)
def test_cfg_front_end_equals_jax(name):
    path, default = os.path.join(CONFIG, name), os.path.join(CONFIG, "default.cfg")
    assert tcfg.parse_cfg(path) == jcfg.parse_cfg(path)
    merged = tcfg.merge_cfgs(tcfg.parse_cfg(default), tcfg.parse_cfg(path))
    assert merged == jcfg.merge_cfgs(jcfg.parse_cfg(default), jcfg.parse_cfg(path))
    assert tcfg.cfg_to_argv(merged) == jcfg.cfg_to_argv(merged)
    argv = tcfg.load_merged_argv(default, path)
    assert argv == jcfg.load_merged_argv(default, path)
    args = infer.get_args(argv)
    assert args.model_size == "tiny" and args.num_frames == 9
    assert bool(args.audio_path) == (name != "default.cfg")


def test_cfg_comments_quotes_and_override(tmp_path):
    (tmp_path / "d.cfg").write_text("--a 1 2  # two values\n--b 'x y'\n# --c 3\n")
    (tmp_path / "s.cfg").write_text('--b "z"\n--flag\n')
    for mod in (tcfg, jcfg):
        assert mod.load_merged_argv(str(tmp_path / "d.cfg"), str(tmp_path / "s.cfg")) == [
            "--a", "1", "2", "--b", "z", "--flag"]


def test_batch_driver_runs_the_golden_sample_on_the_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(ROOT)
    monkeypatch.delenv("BYA_SAM2_CKPT", raising=False)
    rc = batch.main(["--samples", "005.cfg", "--output_root", str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0 and "[batch] 005.cfg: OK" in out
    assert (tmp_path / "005" / "output.mp4").stat().st_size > 0
    assert sorted(os.listdir(tmp_path / "005" / "tracking_mask_results")) == [
        "1", "2", "valid_frame.json"]


def test_batch_driver_exit_code_and_subprocess_mode(tmp_path, monkeypatch):
    """The largest of the samples' codes, an argparse failure (a message
    code) counted as 1; `--subprocess` runs the port's CLI module with the
    package on PYTHONPATH."""
    (tmp_path / "default.cfg").write_text("--model_size tiny\n")
    (tmp_path / "001.cfg").write_text("--num_frames not-a-number\n")
    (tmp_path / "002.cfg").write_text("--fps 5\n")
    monkeypatch.setattr(infer, "main", lambda argv: None if "--fps" in argv else
                        infer.get_args(argv))
    assert batch.main(["--config_dir", str(tmp_path), "--output_root", str(tmp_path / "o"),
                       "--device", "cpu"]) == 2
    seen = []

    def fake_run(cmd, env):
        seen.append((cmd, env["PYTHONPATH"]))
        return subprocess.CompletedProcess(cmd, 3 if "--fps" in cmd else 0)

    monkeypatch.setattr(batch.subprocess, "run", fake_run)
    assert batch.main(["--config_dir", str(tmp_path), "--output_root", str(tmp_path / "o"),
                       "--subprocess"]) == 3
    cmd, pythonpath = seen[1]
    assert cmd[:3] == [sys.executable, "-m", "bindyouravatar_tpu_torch.infer"]
    assert cmd[3:] == ["--model_size", "tiny", "--fps", "5", "--output_dir",
                       str(tmp_path / "o" / "002"), "--device", "cuda"]
    assert pythonpath.split(os.pathsep)[0] == ROOT

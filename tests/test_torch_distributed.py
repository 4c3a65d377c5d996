"""The port's sharded Stage-3 step and launcher on gloo ranks, on the CPU.

Each (dp, fsdp) layout runs in its own spawn of gloo processes
(`torch_dist_worker.py`), started together at the module's start:
* two `train_step`s (AdamW, 2 micro-batches of a global batch of 8, EMA,
  LoRA r256) at fsdp 2 (2 ranks) and at dp 2 x fsdp 2 (4 ranks) against
  one rank's, within relative L2 1e-5 of the trainable tensors' change, the
  EMA's and the moments; every run takes JAX's own draws (keys 5 and 6,
  `test_torch_train_slice.jax_draws`), each rank its rows of them, so that
  `tests/test_torch_distributed_reference.py` holds the one-rank steps
  against JAX's two steps on the same params, batch and draws;
* the other optimizers' refusal under fsdp > 1 (`ROADMAP.md` A12b);
* the mesh bring-up (`init_distributed` from a `file://` store) agreeing on
  an all-reduce over the flattened (dp, fsdp) axis;
* `training.sft --fsdp 2` at 2 ranks, its checkpoint restored at 1 rank and
  continued, against the 2-rank run.
The attention key biases are held apart (as in
`tests/test_torch_train_slice.py`): softmax is invariant to them, their true
gradient is 0, and each run moves them by the fp32 rounding noise that Adam
normalises to about a learning rate; here within 2 learning rates per
element.
"""

import glob
import os
import re
import shutil

import jax
import numpy as np
import pytest
import torch

from bindyouravatar_tpu.config import TrainConfig as JTrainConfig
from bindyouravatar_tpu.models.dit import DiT as JDiT
from bindyouravatar_tpu_torch.config import SchedulerConfig, TrainConfig
from bindyouravatar_tpu_torch.convert import jax_params_to_torch
from bindyouravatar_tpu_torch.models.dit import DiT
from bindyouravatar_tpu_torch.ops.scheduler import Schedule
from bindyouravatar_tpu_torch.training import sft
from bindyouravatar_tpu_torch.training.trainer import Trainer
from test_torch_train_slice import _batch, jax_draws
from torch_dist_worker import Ranks, two_steps
from torch_port_utils import realistic, threads_per_worker

LR = 1e-3
TRAIN_CFG = dict(learning_rate=LR, lr_warmup_steps=1, max_train_steps=10, grad_accum_steps=2,
                 ema_decay=0.9)
# LoRA r256: its A and B (4 layers x 96 x 256) reach the rule's 2^16
# elements, so trainable tensors are sharded too, as at 5B
DIT = dict(lora_rank=256)
KEY_BIAS = re.compile(r".*\.to_k\.bias$")
# the launcher's warmup (100 steps) gives step 2 a hundredth of the rate:
# 1e-3, a change well above the parameters' fp32 resolution
SFT = ["--model_size", "tiny", "--device", "cpu", "--batch_size", "2", "--lora_rank", "4",
       "--learning_rate", "0.1", "--checkpointing_steps", "1", "--checkpoints_total_limit", "3"]


@pytest.fixture(autouse=True, scope="module")
def _threads():
    with threads_per_worker():
        yield


KEYS = (5, 6)


def make_jax_inputs():
    """JAX's tiny DiT (LoRA r256), its realistic params and the batch of 8."""
    jd = JDiT.tiny(**DIT)
    params = jax.tree.map(np.asarray, realistic(jax.eval_shape(jd.init, jax.random.key(0)),
                                                seed=5))
    return jd, params, _batch(jd, b=8)


def make_inputs(jax_inputs):
    """The ranks' inputs: the converted params, the batch and JAX's draws."""
    jd, params, batch = jax_inputs
    jcfg = JTrainConfig(**TRAIN_CFG)
    draws = [jax_draws(jcfg, batch, jax.random.key(k), TRAIN_CFG["grad_accum_steps"])
             for k in KEYS]
    return dict(dit_kwargs=DIT, state=jax_params_to_torch(params), train_cfg=TRAIN_CFG,
                batch={k: torch.from_numpy(v) for k, v in batch.items()}, draws=draws)


def one_rank_steps(inputs):
    """The two steps on one rank, and the trainable tensors before them."""
    td = DiT.tiny(device="cpu", **inputs["dit_kwargs"])
    td.load_state_dict(inputs["state"], strict=True)
    tr = Trainer(td.train(), Schedule.create(SchedulerConfig()), TrainConfig(**TRAIN_CFG))
    before = {k: p.detach().clone() for k, p in tr.trainable.items()}
    return before, two_steps(tr, inputs["batch"], inputs["draws"])


def rel_change(got, want, before, names):
    """|got - want| / |want - before| over the tensors `names` (L2)."""
    num = sum(float(((got[k] - want[k]).double() ** 2).sum()) for k in names)
    den = sum(float(((want[k] - before[k]).double() ** 2).sum()) for k in names)
    return (num / den) ** 0.5


@pytest.fixture(scope="module")
def inputs():
    return make_inputs(make_jax_inputs())


@pytest.fixture(scope="module", autouse=True)
def started(inputs, tmp_path_factory):
    ds = str(tmp_path_factory.mktemp("sft2"))
    sft2 = Ranks("train", 2, ds, dict(
        inputs, layouts=[], sft_argv=SFT + [
            "--fsdp", "2", "--max_train_steps", "2", "--output_dir", os.path.join(ds, "sft"),
            "--num_validation_videos", "1", "--validation_steps", "1"]))
    two = Ranks("train", 2, str(tmp_path_factory.mktemp("train2")), dict(
        inputs, layouts=[(1, 2)], refuse=[("adafactor", False), ("prodigy", False),
                                          ("adamw", True)]))
    four = Ranks("train", 4, str(tmp_path_factory.mktemp("train4")),
                 dict(inputs, layouts=[(2, 2)]))
    yield dict(two=two, four=four, sft2=sft2, sft_dir=os.path.join(ds, "sft"))
    for r in (two, four, sft2):
        r.close()


@pytest.fixture(scope="module")
def one_rank(inputs):
    return one_rank_steps(inputs)


@pytest.fixture(scope="module")
def ranks(started, one_rank):
    return {k: started[k].results() for k in ("two", "four", "sft2")}


@pytest.mark.parametrize("layout,world", [("dp1_fsdp2", "two"), ("dp2_fsdp2", "four")])
def test_sharded_train_steps_match_one_rank(ranks, one_rank, layout, world):
    before, want = one_rank
    for r in ranks[world]:
        got = r[layout]
        assert set(got["params"]) == set(want["params"])
        names = [k for k in want["params"] if not KEY_BIAS.match(k)]
        assert rel_change(got["params"], want["params"], before, names) < 1e-5
        for kind in ("mu", "nu"):
            zero = {k: torch.zeros_like(t) for k, t in want[kind].items()}
            assert rel_change(got[kind], want[kind], zero, names) < 1e-5, kind
        assert rel_change(got["ema"], want["ema"], before, names) < 1e-5
        for k in want["params"]:
            if KEY_BIAS.match(k):
                assert (got["params"][k] - want["params"][k]).abs().max() <= 2 * LR, k
            assert got["params"][k].shape == before[k].shape     # gathered whole


def test_some_trainable_tensors_are_sharded(inputs):
    """The rule shards trainable tensors at fsdp 2 (the step above is not
    a replicated one)."""
    from bindyouravatar_tpu_torch.parallel.sharding import param_specs
    from bindyouravatar_tpu_torch.training.trainer import partition_params

    td = DiT.tiny(device="meta", **inputs["dit_kwargs"])
    specs = param_specs(td, 2)
    trainable, frozen = partition_params(dict(td.named_parameters()))
    assert any(specs[k] is not None for k in trainable)
    assert any(specs[k] is not None for k in frozen)


@pytest.mark.parametrize("opt", ["adafactor_False", "prodigy_False", "adamw_True"])
def test_other_optimizers_refuse_fsdp(ranks, opt):
    for r in ranks["two"]:
        assert "A12b" in r[f"refuse_{opt}"], r[f"refuse_{opt}"]


@pytest.mark.parametrize("layout,world,n", [("dp1_fsdp2", "two", 2), ("dp2_fsdp2", "four", 4)])
def test_mesh_bring_up_agrees_on_an_all_reduce(ranks, layout, world, n):
    """`init_distributed` from a file store, an all-reduce over the
    flattened (dp, fsdp) axis; each rank's `local_batch` rows, placed with
    `batch_sharding`, make the whole batch (and `replicated` keeps it
    whole)."""
    want = float(np.arange(4 * n).sum())
    assert [r[f"sum_{layout}"] for r in ranks[world]] == [want] * n
    assert all(r[f"layout_{layout}"] for r in ranks[world])


def _state(directory, step):
    return torch.load(os.path.join(directory, "checkpoints", str(step), "state.pt"),
                      map_location="cpu", weights_only=True)


def test_sft_fsdp2_checkpoint_resumes_at_one_rank(ranks, started, tmp_path):
    """Steps 1 and 2 at 2 ranks; step 1's checkpoint restored at 1 rank and
    continued to step 2 equals the 2-rank step 2."""
    src = started["sft_dir"]
    assert [r["sft_step"] for r in ranks["sft2"]] == [2, 2]
    assert sorted(os.listdir(os.path.join(src, "checkpoints"))) == ["1", "2"]
    assert glob.glob(os.path.join(src, "validation-2", "video_0.mp4"))
    dst = str(tmp_path / "one")
    shutil.copytree(os.path.join(src, "checkpoints", "1"), os.path.join(dst, "checkpoints", "1"))
    run = sft.main(SFT + ["--max_train_steps", "2", "--output_dir", dst])
    assert run.state.step == 2
    s1, want, got = _state(src, 1)["state"], _state(src, 2), _state(dst, 2)
    assert got["sampler"] == want["sampler"]
    want, got = want["state"], got["state"]
    names = [k for k in want["params"] if not KEY_BIAS.match(k)]
    assert rel_change(got["params"], want["params"], s1["params"], names) < 1e-5
    zero = {k: torch.zeros_like(t) for k, t in want["mu"].items()}
    assert rel_change(got["mu"], want["mu"], zero, names) < 1e-5
    for k in want["params"]:
        if KEY_BIAS.match(k):
            assert (got["params"][k] - want["params"][k]).abs().max() <= 2 * LR, k
    assert got["step"] == want["step"] == 2

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
* the same two steps with adafactor, prodigy and 8-bit AdamW: the first
  step's gradients within relative L2 1e-5 of one rank's, and the two
  updates, replayed on one rank from the gradients the ranks handed their
  optimizer, within the same bound on the parameters, the EMA and every
  tensor of each optimizer's state.  (A whole step on one rank moves
  further: prodigy's distance x0 - x is ~100 fp32 spacings at its first
  d of 1e-6, so a rounding flip changes d, and an 8-bit code flips when a
  last-bit change of the gradient crosses a rounding boundary of its
  grid: 2.3e-5 to 1.8e-4 of the change, measured at these shapes with a
  warmup of one step.)  The state
  after the first step at fsdp 2, restored at one rank and stepped with
  the second step's gradients, against the second step at fsdp 2;
* the three optimizers on parts of whole tensors drawn here, against the
  whole tensors on one rank: rows that the ranks do not divide evenly,
  8-bit blocks that straddle two ranks' parts, adafactor tensors whose
  parts would factor other dims than the whole;
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


def one_rank_trainer(inputs, **over):
    td = DiT.tiny(device="cpu", **inputs["dit_kwargs"])
    td.load_state_dict(inputs["state"], strict=True)
    return Trainer(td.train(), Schedule.create(SchedulerConfig()),
                   TrainConfig(**dict(TRAIN_CFG, **over)))


def one_rank_steps(inputs):
    """The two steps on one rank, and the trainable tensors before them."""
    tr = one_rank_trainer(inputs)
    before = {k: p.detach().clone() for k, p in tr.trainable.items()}
    return before, two_steps(tr, inputs["batch"], inputs["draws"])


def replay(tr, grads, state=None):
    """`apply_gradients` of each of `grads` (whole tensors) on one rank,
    from `state` or a new one; the whole state after them."""
    state = tr.init_state() if state is None else state
    for g in grads:
        state = tr.apply_gradients(state, {k: t.clone() for k, t in g.items()})
    return tr.state_dict(state)


def rel_change(got, want, before, names):
    """|got - want| / |want - before| over the tensors `names` (L2)."""
    num = sum(float(((got[k] - want[k]).double() ** 2).sum()) for k in names)
    den = sum(float(((want[k] - before[k]).double() ** 2).sum()) for k in names)
    return (num / den) ** 0.5


@pytest.fixture(scope="module")
def inputs():
    return make_inputs(make_jax_inputs())


# the three optimizers at the learning rates of tests/test_torch_optimizers.py
# (prodigy's d starts at 1e-6: its lr is 1), with no warmup, so that the
# first step moves the tensors and prodigy's second step has a distance
OPTIMIZERS = {name: dict(over, lr_warmup_steps=0) for name, over in (
    ("adafactor", dict(optimizer="adafactor", learning_rate=1e-2)),
    ("prodigy", dict(optimizer="prodigy", learning_rate=1.0)),
    ("adam8bit", dict(optimizer="adamw", use_8bit_adam=True, learning_rate=1e-2)))}


def part_cases():
    """The optimizer-level cases: whole tensors, the dim each is split
    along over the 2 ranks (None: replicated), two steps of gradients."""
    rng = np.random.default_rng(23)
    f = lambda *shape, std=0.1: torch.from_numpy(rng.normal(0, std, shape).astype(np.float32))

    def case(opt, dims, shapes):
        params = {k: f(*sh) for k, sh in shapes.items()}
        return dict(cfg=dict(OPTIMIZERS[opt], max_train_steps=10), dims=dims, params=params,
                    grads=[{k: f(*sh, std=1e-3) for k, sh in shapes.items()} for _ in range(2)])

    # [129, 256] and [5, 3000] split 65 / 64 and 3 / 2 rows; [129, 256]
    # factors over its rows, so adafactor's column statistic and row-factor
    # mean span the split; [300] replicated
    padded = dict(dims={"w": 0, "b": 0}, shapes={"w": (129, 256), "b": (5, 3000), "r": (300,)})
    cases = {f"padding-{opt}": case(opt, **padded) for opt in OPTIMIZERS}
    # [3, 1000]: block 0 (elements 0-2047) holds rank 0's rows 0-1 and
    # rank 1's row 2; [4, 1500] split along dim 1: every block holds both
    # ranks' columns
    cases["straddle-adam8bit"] = case("adam8bit", {"a": 0, "c": 1},
                                      {"a": (3, 1000), "c": (4, 1500)})
    # [256, 130] -> parts [128, 130], which would factor dims (0, 1)
    # against the whole's (1, 0); [200, 150] -> parts [100, 150], which
    # would not factor at all (100 < 128)
    cases["factor-adafactor"] = case("adafactor", {"f": 0, "g": 0},
                                     {"f": (256, 130), "g": (200, 150)})
    return cases


@pytest.fixture(scope="module", autouse=True)
def started(inputs, tmp_path_factory):
    ds = str(tmp_path_factory.mktemp("sft2"))
    sft2 = Ranks("train", 2, ds, dict(
        inputs, layouts=[], sft_argv=SFT + [
            "--fsdp", "2", "--max_train_steps", "2", "--output_dir", os.path.join(ds, "sft"),
            "--num_validation_videos", "1", "--validation_steps", "1"]))
    two = Ranks("train", 2, str(tmp_path_factory.mktemp("train2")), dict(
        inputs, layouts=[(1, 2)], optimizers=OPTIMIZERS, parts=part_cases()))
    four = Ranks("train", 4, str(tmp_path_factory.mktemp("train4")),
                 dict(inputs, layouts=[(2, 2)], optimizers=OPTIMIZERS))
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


def _state_matches(got, want, before, names, lr, tol=1e-5):
    """The trainable tensors' and the EMA's change and every tensor of the
    optimizer's state (relative to its own norm) within relative L2 `tol`
    of `want`'s; the key biases within 2 learning rates `lr` of `want`'s."""
    kinds = set(want) - {"params", "ema", "step", "count"}
    assert kinds and set(got) >= kinds
    assert rel_change(got["params"], want["params"], before, names) < tol
    assert rel_change(got["ema"], want["ema"], before, names) < tol
    for kind in kinds:
        keys = [k for k in want[kind] if not KEY_BIAS.match(k)]
        if not keys:            # a kind this model has no tensor of
            continue
        as_float = lambda d: {k: t.double() for k, t in d.items()}
        g, w = as_float(got[kind]), as_float(want[kind])
        if all(not t.any() for t in w.values()):        # e.g. no distance yet
            assert all(not g[k].any() for k in keys), kind
            continue
        zero = {k: torch.zeros_like(t) for k, t in w.items()}
        assert rel_change(g, w, zero, keys) < tol, kind
    for k in want["params"]:
        if KEY_BIAS.match(k):
            assert (got["params"][k] - want["params"][k]).abs().max() <= 2 * lr, k
        assert got["params"][k].shape == before[k].shape     # gathered whole


@pytest.mark.parametrize("layout,world", [("dp1_fsdp2", "two"), ("dp2_fsdp2", "four")])
@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_sharded_optimizer_steps_match_one_rank(ranks, one_rank, inputs, opt, layout, world):
    """Two steps of each optimizer at fsdp 2 and at dp 2 x fsdp 2: the first
    step's gradients against one rank's, and the parameters, the EMA and
    the optimizer's state against the same updates on one rank (see the
    module docstring)."""
    before, adamw = one_rank
    names = [k for k in before if not KEY_BIAS.match(k)]
    zero = {k: torch.zeros_like(t) for k, t in before.items()}
    for r in ranks[world]:
        got = r[f"{opt}-{layout}"]
        assert rel_change(got["grads"][0], adamw["grads"][0], zero, names) < 1e-5
        want = replay(one_rank_trainer(inputs, **OPTIMIZERS[opt]), got["grads"])
        _state_matches(got, want, before, names, OPTIMIZERS[opt]["learning_rate"])


@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_sharded_optimizer_checkpoint_restores_at_one_rank(ranks, inputs, opt):
    """The whole state after step 1 at fsdp 2 (every tensor gathered:
    adafactor's factored statistics, 8-bit AdamW's codes and block scales),
    restored at one rank and stepped with step 2's gradients, equals step 2
    at fsdp 2."""
    got2 = ranks["two"][0][f"{opt}-dp1_fsdp2"]
    saved = got2["first"]
    tr = one_rank_trainer(inputs, **OPTIMIZERS[opt])
    want = replay(tr, got2["grads"][1:], tr.load_state_dict(saved, tr.init_state()))
    names = [k for k in saved["params"] if not KEY_BIAS.match(k)]
    _state_matches(got2, want, saved["params"], names, OPTIMIZERS[opt]["learning_rate"])


def _whole(results, key):
    """Each kind's whole tensors from the ranks' parts (`optimizer_parts`):
    split ones put together along their dim, whole ones equal on every
    rank."""
    out = {}
    for kind in results[0][key]:
        out[kind] = {}
        for k, part in results[0][key][kind][1].items():
            pieces = [r[key][kind][0][k] for r in results]
            if part is None:
                assert all(torch.equal(p, pieces[0]) for p in pieces), (kind, k)
                out[kind][k] = pieces[0]
            else:
                out[kind][k] = torch.cat(pieces, dim=part.dim)
                assert tuple(out[kind][k].shape) == part.shape, (kind, k)
    return out


def _one_rank_parts(case):
    from bindyouravatar_tpu_torch.training.trainer import make_optimizer

    params = {k: t.clone() for k, t in case["params"].items()}
    opt = make_optimizer(TrainConfig(**case["cfg"]))
    groups = {"all": sorted(params)}
    state = opt.init(params, groups)
    for i, grads in enumerate(case["grads"]):
        opt.step(params, grads, state, groups, {"all": case["cfg"]["learning_rate"]}, i)
    return dict(params=params, **state)


def _parts_match(ranks, name, exact=False):
    case = part_cases()[name]
    got, want = _whole(ranks["two"], f"parts-{name}"), _one_rank_parts(case)
    assert set(got) == set(want)
    names = sorted(case["params"])
    assert rel_change(got["params"], want["params"], case["params"], names) < 1e-5
    for kind in set(want) - {"params"}:
        assert set(got[kind]) == set(want[kind]), kind
        for k, w in want[kind].items():
            if exact:
                assert torch.equal(got[kind][k], w), (kind, k)
            else:
                g, w = got[kind][k].double(), w.double()
                assert float((g - w).norm()) <= 1e-5 * float(w.norm()), (kind, k)


@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_sharded_optimizer_takes_uneven_parts(ranks, opt):
    """Rows that 2 ranks do not divide (FSDP2's padding: 65 / 64 and 3 / 2
    rows) beside a replicated tensor: two steps equal the whole tensors'
    on one rank (relative L2 1e-5; the sums over the group run in another
    order)."""
    _parts_match(ranks, f"padding-{opt}")


def test_8bit_blocks_straddle_ranks(ranks):
    """8-bit AdamW on parts whose blocks straddle the two ranks (rows and
    columns): codes and block scales equal the whole tensors' bit for bit
    (the absmax is exact in any order)."""
    _parts_match(ranks, "straddle-adam8bit", exact=True)


def test_adafactor_factors_the_whole_shape(ranks):
    """Adafactor on parts that would factor other dims than the whole
    tensor (or none): the statistics take the whole shape's."""
    _parts_match(ranks, "factor-adafactor")


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

"""The port's optimizers (adafactor, prodigy, 8-bit AdamW) against the JAX
trainer's `make_optimizer`, on the CPU in fp32.

The trainable tree is `DiT.tiny(lora_rank=4)`'s real one (scan-stacked in
JAX, one tensor per layer in the port); three steps of gradients drawn
with numpy (the clip active in one of them) go through JAX's optax chain
(eagerly, no train-step jit) and through `Trainer.apply_gradients`.
Tolerance: each element of each step's update within 1e-6 of the update's
largest magnitude, plus one fp32 spacing of the parameter (both sides add
the update to the same fp32 parameter, so equal updates give equal
parameters and a difference d in the update a difference of at most d and
a rounding).  The 8-bit AdamW is held so on a tree laid out like the port's
tensors (its blocks run over each tensor's own flattened order), with JAX
run eagerly and gradients under the clip: a jitted XLA update contracts
multiply-adds into FMAs and the clip's norm sums in another order, each a
last-bit change of the first moment that moves some elements across a
rounding boundary of the int8 grid (one quantum, ~1/127 of the block's
absmax).  The difference on JAX's stacked tree is stated beside it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bindyouravatar_tpu.config import TrainConfig as JTrainConfig
from bindyouravatar_tpu.models.dit import DiT as JDiT
from bindyouravatar_tpu.training import adam8bit as jadam8bit
from bindyouravatar_tpu.training import trainer as jtrainer
from bindyouravatar_tpu_torch.config import SchedulerConfig, TrainConfig
from bindyouravatar_tpu_torch.convert import (jax_opt_state_to_torch, jax_params_to_torch,
                                               jax_state_to_torch)
from bindyouravatar_tpu_torch.models.dit import DiT
from bindyouravatar_tpu_torch.ops.scheduler import Schedule
from bindyouravatar_tpu_torch.training import adam8bit
from bindyouravatar_tpu_torch.training.adafactor import Adafactor, stacked_leaves
from bindyouravatar_tpu_torch.training.checkpoint import restore_checkpoint, save_checkpoint
from bindyouravatar_tpu_torch.training.trainer import Trainer
from torch_port_utils import realistic, threads_per_worker

SCALES = (0.002, 0.01, 0.003)       # gradient scales: the global norm passes 1 in steps 2, 3
UNCLIPPED = (0.001, 0.0015, 0.0012)  # global norms 0.48, 0.72, 0.57: the 8-bit runs
BASE = dict(lr_scheduler="constant", max_train_steps=10)
OPTIMIZERS = {
    "adafactor": dict(optimizer="adafactor", learning_rate=1e-2),
    "adafactor_diff_lr": dict(optimizer="adafactor", learning_rate=1e-2, is_diff_lr=True),
    "prodigy": dict(optimizer="prodigy", learning_rate=1.0),
    "prodigy_diff_lr": dict(optimizer="prodigy", learning_rate=1.0, is_diff_lr=True),
    # every flag away from its default in one run (each JAX reference run is
    # a jit compile of several seconds)
    "prodigy_flags": dict(optimizer="prodigy", learning_rate=1.0, prodigy_beta3=0.9,
                          prodigy_decouple=False, prodigy_use_bias_correction=True,
                          prodigy_safeguard_warmup=True),
    "adam8bit": dict(optimizer="adamw", use_8bit_adam=True, learning_rate=1e-2),
    "adam8bit_diff_lr": dict(optimizer="adamw", use_8bit_adam=True, learning_rate=1e-2,
                             is_diff_lr=True),
}


@pytest.fixture(autouse=True, scope="module")
def _threads():
    with threads_per_worker():
        yield


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    """JAX's tiny LoRA-r4 params at realistic scale, their trainable
    partition, and three drawn gradient trees of that partition (one
    direction plus noise, so prodigy's distance estimate grows)."""
    jd = JDiT.tiny(lora_rank=4)
    params = realistic(jax.eval_shape(jd.init, jax.random.key(0)), seed=5)
    jtrain, _ = jtrainer.partition_params(params)
    rng = np.random.default_rng(17)
    base = jax.tree.map(lambda x: rng.standard_normal(x.shape), jtrain)
    draw = lambda scales: [jax.tree.map(lambda b: (s * (b + 0.5 * rng.standard_normal(b.shape)))
                                        .astype(np.float32), base) for s in scales]
    return params, jtrain, draw(SCALES), draw(UNCLIPPED)


def _jax_steps(tx, tree, grads, steps=3, jit=True):
    """[(params, opt_state, updates)] after each of `steps` updates (the
    optimizer's update jitted unless `jit=False`: it is the JAX reference,
    not a train step)."""
    p = jax.tree.map(jnp.asarray, tree)
    state = tx.init(p)
    update = jax.jit(tx.update) if jit else tx.update
    out = []
    for g in grads[:steps]:
        upd, state = update(jax.tree.map(jnp.asarray, g), state, p)
        p = optax.apply_updates(p, upd)
        out.append((_np(p), state, _np(upd)))
    return out


def _two_group_8bit(cfg: JTrainConfig):
    """JAX's `is_diff_lr` chain for 8-bit AdamW written out: the global clip,
    then `adamw8bit` per group (the perceivers at lr * diff_lr_high, the rest
    at lr * diff_lr_low).  JAX's own chain, `multi_transform` around
    `adamw8bit`, fails on its masked leaves (`test_jax_8bit_two_groups_fails`)."""
    sched = jtrainer.make_lr_schedule(cfg)
    txs = {label: jadam8bit.adamw8bit(lambda c, m=mult: sched(c) * m, b1=cfg.adam_beta1,
                                      b2=cfg.adam_beta2, eps=cfg.adam_epsilon,
                                      weight_decay=cfg.weight_decay)
           for label, mult in (("high", cfg.diff_lr_high), ("low", cfg.diff_lr_low))}
    label = lambda k: "high" if k.startswith("perceiver") else "low"
    split = lambda t, lab: {k: v for k, v in t.items() if label(k) == lab}

    def init(params):
        return {lab: tx.init(split(params, lab)) for lab, tx in txs.items()}

    def update(g, state, params):
        g, _ = optax.clip_by_global_norm(cfg.max_grad_norm).update(g, optax.EmptyState())
        out, new = {}, {}
        for lab, tx in txs.items():
            u, new[lab] = tx.update(split(g, lab), state[lab], split(params, lab))
            out.update(u)
        return out, new

    return optax.GradientTransformation(init, update)


def _trainer(params, **cfg):
    td = DiT.tiny(device="cpu", lora_rank=4)
    td.load_state_dict(jax_params_to_torch(params), strict=True)
    return Trainer(td, Schedule.create(SchedulerConfig()), TrainConfig(**BASE, **cfg))


def _assert_step(got_before, got_after, want_upd, want_after, what):
    """The port's update (after - before) against JAX's, per the file's
    tolerance, and the parameters within it."""
    for k, w in want_upd.items():
        u = (got_after[k].double() - got_before[k].double())
        w = w.double()
        tol = 1e-6 * float(w.abs().max()) + torch.finfo(torch.float32).eps * (
            want_after[k].double().abs() + 1e-30)
        assert bool(((u - w).abs() <= tol).all()), (
            what, k, float((u - w).abs().max()), float(w.abs().max()))


@pytest.fixture(scope="module")
def jax_runs(setup):
    """JAX's three steps for each of `OPTIMIZERS` (8-bit: on the port's
    layout too, `port_layout`)."""
    params, jtrain, grads, unclipped = setup
    runs = {}
    port_tree = {k: v.numpy() for k, v in jax_params_to_torch(jtrain).items()}
    port_grads = [{k: v.numpy() for k, v in jax_params_to_torch(g).items()} for g in unclipped]
    for name, cfg in OPTIMIZERS.items():
        jcfg = JTrainConfig(**BASE, **cfg)
        if cfg.get("use_8bit_adam") and cfg.get("is_diff_lr"):
            runs[name + "/port_layout"] = _jax_steps(_two_group_8bit(jcfg), port_tree,
                                                     port_grads, jit=False)
            continue
        tx = jtrainer.make_optimizer(jcfg)
        if cfg.get("use_8bit_adam"):
            runs[name] = _jax_steps(tx, jtrain, unclipped)
            runs[name + "/port_layout"] = _jax_steps(tx, port_tree, port_grads, jit=False)
        else:
            runs[name] = _jax_steps(tx, jtrain, grads)
    return runs


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_three_steps_match_jax(setup, jax_runs, name):
    """Every trainable tensor's update of each step, and the optimizer's
    kinds of state, against JAX's `make_optimizer` (8-bit AdamW: JAX run on
    the port's layout; on its own stacked layout the quantization blocks
    differ: an element whose sqrt(v) rounds to another level moves by a
    different step, and after three steps the parameters differ by up to the
    largest update, stated here)."""
    params, jtrain, grads, unclipped = setup
    tr = _trainer(params, **OPTIMIZERS[name])
    state = tr.init_state()
    port_layout = OPTIMIZERS[name].get("use_8bit_adam", False)
    run = jax_runs[name + ("/port_layout" if port_layout else "")]
    if port_layout:
        grads = unclipped
    for step, g in enumerate(grads):
        before = {k: p.detach().clone() for k, p in tr.trainable.items()}
        state = tr.apply_gradients(state, jax_params_to_torch(g))
        want_p, _, want_u = run[step]
        conv = (lambda t: {k: torch.from_numpy(np.asarray(v)) for k, v in t.items()}) \
            if port_layout else jax_params_to_torch
        _assert_step(before, tr.trainable, conv(want_u), conv(want_p), (name, step))
    assert state.count == state.step == 3
    kinds = {"adafactor": {"v_row", "v_col", "v"},
             "prodigy": {"exp_avg", "exp_avg_sq", "s", "p0", "d", "d_max", "d_numerator"},
             "adam8bit": {"qm", "qv", "sm", "sv"}}[name.split("_")[0]]
    assert set(state.opt) == kinds
    if port_layout and name in jax_runs:
        stacked = jax_params_to_torch(jax_runs[name][-1][0])
        diff = max(float((tr.trainable[k] - w).abs().max()) for k, w in stacked.items())
        largest = max(float(np.abs(u).max()) for u in jax.tree.leaves(jax_runs[name][-1][2]))
        assert 0.0 < diff <= largest, (diff, largest)
    if name.startswith("prodigy"):
        labels = {"high", "low"} if "diff_lr" in name else {"all"}
        assert set(state.opt["d"]) == labels
        assert all(float(n) > 0.0 for n in state.opt["d_numerator"].values())


def test_adafactor_factors_stacked_and_transposed_leaves():
    """optax's adafactor on a stacked tree whose leaves factor (both sides of
    [3, 130, 160] and [2, 128, 128] at least 128; a [192, 1] kernel does
    not): the port's `Adafactor` on the converted, transposed per-layer
    tensors, with the block RMS over JAX's stacked leaves, gives JAX's
    updates, and `jax_opt_state_to_torch` gives the port's statistics."""
    rng = np.random.default_rng(3)
    f = lambda *s: (0.1 * rng.standard_normal(s)).astype(np.float32)
    tree = {"blocks": {"ff": {"net_0": {"kernel": f(3, 130, 160), "bias": f(3, 160)}}},
            "audio_layers": {"to_q": {"kernel": f(2, 128, 128)}},
            "router_trunk": {"final_proj": {"kernel": f(192, 1)}}}
    grads = [jax.tree.map(lambda x: f(*x.shape) * s, tree) for s in (1.0, 0.3, 2.0)]
    tx = optax.adafactor(1e-2)
    run = _jax_steps(tx, tree, grads)
    port = {k: v.clone() for k, v in jax_params_to_torch(tree).items()}
    assert port["blocks.0.ff.net_0.weight"].shape == (160, 130)
    opt = Adafactor()
    groups = {"all": list(port)}
    state = opt.init(port, groups)
    assert set(state["v_row"]) == {n for n in port if n.endswith("weight") and "final" not in n}
    for step, g in enumerate(grads):
        before = {k: v.clone() for k, v in port.items()}
        opt.step(port, jax_params_to_torch(g), state, groups, {"all": 1e-2}, step)
        want_p, want_state, want_u = run[step]
        _assert_step(before, port, jax_params_to_torch(want_u), jax_params_to_torch(want_p),
                     ("factored", step))
    count, conv = jax_opt_state_to_torch(_np(run[-1][1]), tree)
    assert count == 3
    for kind in ("v_row", "v_col", "v"):
        assert set(conv[kind]) == set(state[kind])
        for k, t in state[kind].items():
            torch.testing.assert_close(conv[kind][k], t, rtol=1e-6, atol=0)
    assert list(stacked_leaves(port)) == sorted({"audio_layers.*.to_q.weight",
                                                 "blocks.*.ff.net_0.weight",
                                                 "blocks.*.ff.net_0.bias",
                                                 "router_trunk.final_proj.weight"})


@pytest.mark.parametrize("name", ["adafactor_diff_lr", "prodigy_diff_lr", "adam8bit"])
def test_port_continues_a_converted_jax_state(setup, jax_runs, name):
    """JAX's train state after step 1 through `jax_state_to_torch`; the
    port's steps 2 and 3 from it against JAX's.  The 8-bit moments are
    dequantized in JAX's stacked layout and quantized again in the port's:
    the converted first moment is within half a quantization step of
    JAX's (its block's absmax / 254, at most 1/254 of the tensor's largest
    |m|); steps 2 and 3 then differ from JAX's by the two layouts'
    quantization, stated below (under the largest update)."""
    params, jtrain, grads, unclipped = setup
    if name == "adam8bit":
        grads = unclipped
    p1, s1, _ = jax_runs[name][0]
    jstate = jtrainer.TrainState(step=jnp.asarray(1), params=p1, opt_state=s1, ema_params=None)
    got_params, tstate = jax_state_to_torch(_np(jstate))
    tr = _trainer(params, **OPTIMIZERS[name])
    fresh = tr.init_state()
    assert tstate.step == tstate.count == 1
    assert {k: set(v) for k, v in tstate.opt.items()} == {k: set(v) for k, v in fresh.opt.items()}
    with torch.no_grad():
        for k, v in got_params.items():
            tr.trainable[k].copy_(v)
    for step in (1, 2):
        before = {k: p.detach().clone() for k, p in tr.trainable.items()}
        tstate = tr.apply_gradients(tstate, jax_params_to_torch(grads[step]))
        want_p, _, want_u = jax_runs[name][step]
        if name != "adam8bit":
            _assert_step(before, tr.trainable, jax_params_to_torch(want_u),
                         jax_params_to_torch(want_p), (name, step))
    if name == "adam8bit":
        adam = next(x for x in jax.tree_util.tree_leaves(
            s1, is_leaf=lambda x: isinstance(x, jadam8bit.Adam8bitState))
            if isinstance(x, jadam8bit.Adam8bitState))
        m_jax = jax_params_to_torch(jax.tree.map(
            lambda q, s: np.asarray(jadam8bit._dequant_m(q, s, 2048)), adam.qm, adam.sm))
        _, conv = jax_opt_state_to_torch(_np(s1), jtrain)
        worst = max(float((adam8bit.dequantize_m(conv["qm"][k], conv["sm"][k]) - m).abs().max()
                          / float(m.abs().max())) for k, m in m_jax.items()
                    if float(m.abs().max()) > 0)
        assert worst <= 1.0 / 254 + 1e-6, worst
        want = jax_params_to_torch(jax_runs[name][2][0])
        largest = max(float(np.abs(u).max()) for u in jax.tree.leaves(jax_runs[name][2][2]))
        diff = max(float((tr.trainable[k] - w).abs().max()) for k, w in want.items())
        assert diff <= largest, (diff, largest)


@pytest.mark.parametrize("name", ["adafactor", "prodigy_diff_lr", "adam8bit"])
def test_save_and_exact_resume_of_each_state(setup, tmp_path, name):
    """A step, a checkpoint (`training/checkpoint.py`), a restore into a
    fresh trainer from the same start, and a second step on both: the
    parameters and every state tensor equal bit for bit."""
    params, _, grads, _ = setup
    g = [jax_params_to_torch(x) for x in grads]
    a = _trainer(params, **OPTIMIZERS[name])
    sa = a.apply_gradients(a.init_state(), g[0])
    save_checkpoint(str(tmp_path), 1, {"state": a.state_dict(sa)})
    b = _trainer(params, **OPTIMIZERS[name])
    sb = b.load_state_dict(restore_checkpoint(str(tmp_path))["state"], b.init_state())
    assert sb.step == sb.count == 1
    sa, sb = a.apply_gradients(sa, dict(g[1])), b.apply_gradients(sb, jax_params_to_torch(grads[1]))
    assert all(torch.equal(a.trainable[k], b.trainable[k]) for k in a.trainable)
    for kind, part in sa.opt.items():
        assert all(torch.equal(t, sb.opt[kind][k]) for k, t in part.items()), kind


def test_adamw_checkpoint_of_the_first_format_restores(setup, tmp_path):
    """AdamW's state keeps the format's first layout (`mu`, `nu` beside the
    step, count, params and EMA), so such a checkpoint restores; another
    optimizer's trainer refuses it."""
    params, _, grads, _ = setup
    a = _trainer(params, optimizer="adamw", learning_rate=1e-2)
    sa = a.apply_gradients(a.init_state(), jax_params_to_torch(grads[0]))
    saved = a.state_dict(sa)
    assert set(saved) == {"step", "count", "params", "mu", "nu", "ema"}
    save_checkpoint(str(tmp_path), 1, {"state": saved})
    payload = restore_checkpoint(str(tmp_path))["state"]
    b = _trainer(params, optimizer="adamw", learning_rate=1e-2)
    sb = b.load_state_dict(payload, b.init_state())
    assert all(torch.equal(sb.opt[kind][k], sa.opt[kind][k])
               for kind in ("mu", "nu") for k in sa.opt["mu"])
    c = _trainer(params, **OPTIMIZERS["adafactor"])
    with pytest.raises(ValueError, match="adafactor"):
        c.load_state_dict(payload, c.init_state())


def test_every_tensor_is_quantized_as_jax_does(setup):
    """C4 fault 1, pinned: 8-bit AdamW quantizes every tensor, however
    small, as JAX's `adamw8bit` does (a [96] bias, a [1, 4, 16] mute token
    tensor: int8 / uint8 state), where bitsandbytes' AdamW8bit keeps
    tensors of fewer than 4,096 elements in fp32."""
    params, jtrain, _, _ = setup
    tr = _trainer(params, **OPTIMIZERS["adam8bit"])
    state = tr.init_state()
    small = [k for k, p in tr.trainable.items() if p.numel() < 4096]
    assert "audio_statics.mute_learnable_tokens" in small
    assert all(state.opt["qm"][k].dtype == torch.int8 and state.opt["qv"][k].dtype == torch.uint8
               for k in small)
    jstate = jtrainer.make_optimizer(JTrainConfig(**BASE, **OPTIMIZERS["adam8bit"])).init(jtrain)
    adam = next(x for x in jax.tree_util.tree_leaves(
        jstate, is_leaf=lambda x: isinstance(x, jadam8bit.Adam8bitState))
        if isinstance(x, jadam8bit.Adam8bitState))
    assert adam.qm["audio_statics"]["mute_learnable_tokens"].dtype == jnp.int8


def test_8bit_flag_with_another_optimizer_raises(setup):
    """C4 fault 2, pinned: `use_8bit_adam` with prodigy or adafactor raises
    in the port's trainer and launcher; JAX's `make_optimizer` reads the
    flag only under AdamW and runs full-precision prodigy."""
    from bindyouravatar_tpu_torch.training import sft

    params, jtrain, _, _ = setup
    for opt in ("prodigy", "adafactor"):
        with pytest.raises(ValueError, match="use_8bit_adam"):
            _trainer(params, optimizer=opt, use_8bit_adam=True)
        with pytest.raises(ValueError, match="use_8bit_adam"):
            sft.main(["--device", "cpu", "--optimizer", opt, "--use_8bit_adam"])
    jstate = jtrainer.make_optimizer(JTrainConfig(**BASE, optimizer="prodigy",
                                                  use_8bit_adam=True)).init(jtrain)
    kinds = {type(x).__name__ for x in jax.tree_util.tree_leaves(
        jstate, is_leaf=lambda x: hasattr(x, "_fields"))}
    assert "ProdigyState" in kinds and "Adam8bitState" not in kinds


def test_jax_8bit_two_groups_fails():
    """A fault on JAX's side, pinned: `is_diff_lr` with `use_8bit_adam` fails
    in JAX's first update (`adam8bit.py`'s `pick` indexes the empty
    `MaskedNode` leaves of `optax.multi_transform`); the port runs it (held
    above against the same chain written out, `_two_group_8bit`)."""
    tx = jtrainer.make_optimizer(JTrainConfig(**BASE, **OPTIMIZERS["adam8bit_diff_lr"]))
    p = {"perceiver": {"to_q": {"kernel": jnp.ones((2, 4, 4))}},
         "audio_layers": {"to_q": {"kernel": jnp.ones((2, 4, 4))}}}
    with pytest.raises(IndexError):
        tx.update(jax.tree.map(lambda x: 0.1 * x, p), tx.init(p), p)


def test_8bit_quantizers_match_jax():
    """The quantizers on ragged sizes (a partial last block, an all-zero
    block, ties at .5): the port's against JAX's, bit for bit."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal(5000).astype(np.float32)
    x[2048:4096] = 0.0
    x[:8] = np.array([0.5, -0.5, 1.5, 2.5, -2.5, 127.0, -127.0, 0.0]) / 127.0 * float(np.abs(x[:2048]).max())
    v = np.abs(x) ** 2
    qm, sm = jadam8bit._quant_m(jnp.asarray(x), 2048)
    qv, sv = jadam8bit._quant_v(jnp.asarray(v), 2048)
    tqm, tsm = adam8bit.quantize_m(torch.from_numpy(x))
    tqv, tsv = adam8bit.quantize_v(torch.from_numpy(v))
    for a, b in ((tqm, qm), (tsm, sm), (tqv, qv), (tsv, sv)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert np.array_equal(adam8bit.dequantize_m(tqm, tsm).numpy(),
                          np.asarray(jadam8bit._dequant_m(qm, sm, 2048)))
    assert np.array_equal(adam8bit.dequantize_v(tqv, tsv).numpy(),
                          np.asarray(jadam8bit._dequant_v(qv, sv, 2048)))

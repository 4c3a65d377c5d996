"""The Stage-3 train step of the port against the JAX package, on the CPU,
on the tiny DiT with LoRA r4 (`DiT.tiny(lora_rank=4)`, face + audio).

Same realistic-scale weights (LoRA B non-zero, so LoRA A takes gradients),
the same batch (the `tests/test_training.py` schema, made with numpy) and
JAX's own random draws (timesteps, noise, dropout keeps, the mask-loss
coin) handed to the port's `loss_and_metrics`.  fp32 on both sides.  JAX's
steps for the optimizer options (AdamW, EMA, the two-group learning rate)
share one jitted forward and backward (`jax_run`).
Tolerances: the loss and each metric 1e-4 relative (a 4-layer forward and
backward, sums in another order); the updated trainable parameters within
5e-4 of the learning rate of JAX's (AdamW's first steps move each element
by about the learning rate, m / sqrt(v) ~ +-1, so this is 0.05% of a
step).  The attention key biases are the exception: softmax is invariant
to them, their true gradient is 0, and both sides move them by fp32
rounding noise that Adam normalises; they stay within 5e-3 of the learning
rate (each moved by at most a few thousandths of a step in all).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bindyouravatar_tpu.config import SchedulerConfig as JSchedulerConfig
from bindyouravatar_tpu.config import TrainConfig as JTrainConfig
from bindyouravatar_tpu.models.dit import DiT as JDiT
from bindyouravatar_tpu.ops.scheduler import Schedule as JSchedule
from bindyouravatar_tpu.training import trainer as jtrainer
from bindyouravatar_tpu_torch.config import SchedulerConfig, TrainConfig
from bindyouravatar_tpu_torch.convert import (check_trainable_set, jax_params_to_torch,
                                               jax_state_to_torch)
from bindyouravatar_tpu_torch.models.dit import DiT
from bindyouravatar_tpu_torch.ops.scheduler import Schedule
from bindyouravatar_tpu_torch.training.trainer import Trainer, make_lr_schedule
from torch_port_utils import realistic, threads_per_worker

LR = 1e-3
CFG = dict(learning_rate=LR, lr_warmup_steps=1, max_train_steps=10)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    """Torch's threads at this xdist worker's share of the cores."""
    with threads_per_worker():
        yield


def _rel(got, want) -> float:
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-6)


def _batch(jd, b=2, seed=11):
    """Numpy batch of the trainer's schema (`tests/test_training.py`)."""
    c, a, lf = jd.cfg, jd.audio_cfg, jd.lfe_cfg
    t = c.latent_frames
    s = c.video_seq_len
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    n_af = c.sample_frames + a.window_size - a.window_stride
    teacher = (rng.uniform(size=(b, s, c.num_ids)) > 0.5).astype(np.float32)
    return dict(
        video_latents=f(b, t, 4, c.sample_height, c.sample_width),
        image_latents=f(b, t, 4, c.sample_height, c.sample_width),
        prompt_embeds=f(b, c.max_text_seq_length, c.text_embed_dim),
        id_cond=f(b, c.num_ids, lf.id_embed_dim),
        id_vit_hidden=f(b, c.num_ids, lf.num_scales, 9, lf.vit_dim),
        audio_embeds=f(b, 2, n_af, a.blocks, a.audio_dim),
        af_matrix=np.repeat(np.eye(c.num_ids, dtype=np.float32)[None], b, 0),
        teacher_clean=teacher,
        teacher_noisy=np.clip(teacher + 0.1 * f(*teacher.shape), 0, 1),
        dense_mask=(rng.uniform(size=(b, t, c.sample_height, c.sample_width)) > 0.5).astype(
            np.float32))


def jax_draws(cfg, batch, rng, accum):
    """The draws of the JAX `Trainer.loss_and_metrics` for each micro-batch
    (`_grads_and_metrics` splits the step's key per micro-batch), as the
    port's `Trainer.draw` returns them."""
    rngs = [rng] if accum == 1 else list(jax.random.split(rng, accum))
    shape = batch["video_latents"].shape
    b = shape[0] // accum
    out = []
    for r in rngs:
        r_t, r_noise, r_img, r_bg, r_mask, r_loss, _ = jax.random.split(r, 7)
        u = lambda key, shp: np.asarray(jax.random.uniform(key, shp))
        out.append(dict(
            t=torch.from_numpy(np.array(jax.random.randint(r_t, (b,), 0, 1000))).long(),
            noise=torch.from_numpy(np.array(
                jax.random.normal(r_noise, (b,) + shape[1:], jnp.float32))),
            keep_img=torch.from_numpy(u(r_img, (b, 1, 1, 1, 1)) >= cfg.noised_image_dropout),
            keep_bg=torch.from_numpy(u(r_bg, (b, 1, 1, 1, 1)) >= cfg.drop_inpaint_prob),
            keep_mask=torch.from_numpy(u(r_mask, (b, 1, 1)) >= cfg.index_mask_drop_prob),
            use_mask_loss=torch.tensor(bool(u(r_loss, ()) < cfg.mask_prob)),
            dropout_keep=None))          # two audio tracks: no mute tokens
    return out


@pytest.fixture(scope="module")
def setup():
    jd = JDiT.tiny(lora_rank=4)
    params = realistic(jax.eval_shape(jd.init, jax.random.key(0)), seed=5)
    td = DiT.tiny(device="cpu", lora_rank=4)
    td.load_state_dict(jax_params_to_torch(params), strict=True)
    return jd, params, td


def test_trainable_set_is_the_converted_jax_partition(setup):
    """Same names and element counts as JAX's trainable partition,
    converted; LoRA, router, audio layers and mute tokens in, LFE and the
    base attention out."""
    jd, params, td = setup
    jtrain, _ = jtrainer.partition_params(params)
    tr = Trainer(td, Schedule.create(SchedulerConfig()), TrainConfig(**CFG))
    check_trainable_set(jtrain, tr.trainable)
    names = set(tr.trainable)
    assert "blocks.0.attn1.to_q_lora_A" in names and "audio_statics.mute_learnable_tokens" in names
    assert not any(n.startswith("lfe.") for n in names)
    assert "blocks.0.attn1.to_q.weight" in tr.frozen


@pytest.mark.parametrize("warmup,scheduler", [(1, "cosine_with_restarts"), (0, "cosine_with_restarts"),
                                              (3, "constant")])
def test_lr_schedule_matches_optax(warmup, scheduler):
    cfg = dict(learning_rate=LR, lr_warmup_steps=warmup, max_train_steps=10,
               lr_scheduler=scheduler)
    want = jtrainer.make_lr_schedule(JTrainConfig(**cfg))
    got = make_lr_schedule(TrainConfig(**cfg))
    for count in range(12):
        assert abs(got(count) - float(want(count))) <= 1e-9


# the optimizer configurations whose JAX steps `jax_run` takes
OPTIMIZERS = {"adamw": {}, "ema": dict(ema_decay=0.9), "diff_lr": dict(is_diff_lr=True)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_run(setup):
    """JAX's two train steps (keys 5 and 6) on `_batch(jd)` for each of
    `OPTIMIZERS`, from the same params.  JAX's forward and backward
    (`Trainer._grads_and_metrics`, CFG's loss, which every configuration
    shares) is jitted once; each configuration's `Trainer.train_step` runs
    JAX's own optimizer and EMA code around it."""
    jd, params, _ = setup
    base = jtrainer.Trainer(dit=jd, schedule=JSchedule.create(JSchedulerConfig()),
                            cfg=JTrainConfig(**CFG))
    grads_fn = jax.jit(base._grads_and_metrics)

    class SharedGrads(jtrainer.Trainer):
        def _grads_and_metrics(self, p, frozen, batch, rng):
            return grads_fn(p, frozen, batch, rng)

    batch = _batch(jd)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    runs = {}
    for name, extra in OPTIMIZERS.items():
        jtr = SharedGrads(dit=jd, schedule=base.schedule, cfg=JTrainConfig(**CFG, **extra))
        state, frozen = jtr.init_state(jax.tree.map(jnp.asarray, params))
        states, metrics = [state], []
        for key in (5, 6):
            state, m = jtr.train_step(state, frozen, jbatch, jax.random.key(key))
            states.append(state)
            metrics.append(m)
        runs[name] = (states, metrics)
    return batch, runs


def _port_trainer(params, **extra):
    td = DiT.tiny(device="cpu", lora_rank=4)
    td.load_state_dict(jax_params_to_torch(params), strict=True)
    return Trainer(td, Schedule.create(SchedulerConfig()), TrainConfig(**CFG, **extra))


def _lr_factors(tr):
    """Each trainable tensor's factor of the learning rate (its group's)."""
    return {k: tr.lr_factors[label] for label, names in tr.groups.items() for k in names}


def _assert_params_close(tr, got, jax_tree):
    """`got` (name -> tensor) against a JAX trainable tree: within 5e-4 of
    the tensor's learning rate (5e-3 for the attention key biases)."""
    want = jax_params_to_torch(_np(jax_tree))
    assert set(want) == set(got)
    for k, w in want.items():
        tol = (5e-3 if k.endswith("to_k.bias") else 5e-4) * LR * _lr_factors(tr)[k]
        assert float((got[k].detach() - w).abs().max()) < tol, k


def test_two_train_steps_match_jax(setup, jax_run):
    """Two optimizer steps of 2 micro-batches each (grad_accum_steps=2):
    loss, every metric, grad_norm and every updated trainable parameter."""
    jd, params, td = setup
    batch, runs = jax_run
    (_, _, state), jms = runs["adamw"]
    jcfg = JTrainConfig(**CFG)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tr = _port_trainer(params)
    tstate = tr.init_state()
    for key, jm in zip((5, 6), jms):
        rng = jax.random.key(key)
        tstate, tm = tr.train_step(tstate, tbatch, draws=jax_draws(jcfg, batch, rng, 2))
        assert set(tm) == set(jm)
        for k in jm:
            assert _rel(tm[k], jm[k]) < 1e-4, (key, k, float(tm[k]), float(jm[k]))
    assert tstate.step == int(state.step) == 2
    _assert_params_close(tr, tr.trainable, state.params)
    want = jax_params_to_torch(_np(state.params))
    moved = [k for k, w in want.items()
             if not torch.equal(w, jax_params_to_torch(jtrainer.partition_params(params)[0])[k])]
    assert len(moved) > 0.9 * len(want)


@pytest.mark.parametrize("name", ["ema", "diff_lr"])
def test_ema_and_two_group_lr_steps_match_jax(setup, jax_run, name):
    """`ema_decay=0.9` (the EMA copy after each update) and `is_diff_lr`
    (the perceivers at 10x the learning rate, every other tensor at 0.1x,
    weight decay with them): the second step (the first with a non-zero
    learning rate) against JAX's, params and EMA within the file's
    tolerance of each tensor's learning rate."""
    _, params, _ = setup
    batch, runs = jax_run
    (_, _, state), _ = runs[name]
    jcfg = JTrainConfig(**CFG)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tr = _port_trainer(params, **OPTIMIZERS[name])
    tstate = tr.init_state()
    for key in (5, 6):
        tstate, _ = tr.train_step(tstate, tbatch,
                                  draws=jax_draws(jcfg, batch, jax.random.key(key), 2))
    _assert_params_close(tr, tr.trainable, state.params)
    if name == "ema":
        _assert_params_close(tr, tstate.ema, state.ema_params)
        assert not torch.equal(tstate.ema["perceivers.0.to_q.weight"],
                               tr.trainable["perceivers.0.to_q.weight"])
    else:
        assert tstate.ema is None
        factors = _lr_factors(tr)
        assert factors["perceivers.0.to_q.weight"] == 10.0
        assert factors["blocks.0.attn1.to_q_lora_A"] == 0.1
        assert sum(factors[k] == 10.0 for k in tr.trainable) == sum(
            k.startswith("perceivers.") for k in tr.trainable) > 0


@pytest.mark.parametrize("name", ["adamw", "ema"])
def test_port_continues_a_converted_jax_train_state(setup, jax_run, name):
    """JAX's state after step 1 (trainable params, AdamW mu / nu / count,
    step, EMA) through `jax_state_to_torch`; the port's step 2 from
    it against JAX's step 2."""
    _, params, _ = setup
    batch, runs = jax_run
    (_, s1, s2), _ = runs[name]
    got_params, tstate = jax_state_to_torch(_np(s1))
    assert tstate.step == tstate.count == 1 and (tstate.ema is None) == (name == "adamw")
    tr = _port_trainer(params, **OPTIMIZERS[name])
    tr.init_state()
    assert set(tstate.opt) == {"mu", "nu"}
    assert set(got_params) == set(tstate.opt["mu"]) == set(tstate.opt["nu"]) == set(tr.trainable)
    with torch.no_grad():
        for k, v in got_params.items():
            tr.trainable[k].copy_(v)
    tstate, _ = tr.train_step(tstate, {k: torch.from_numpy(v) for k, v in batch.items()},
                              draws=jax_draws(JTrainConfig(**CFG), batch, jax.random.key(6), 2))
    assert tstate.step == int(s2.step) == 2
    _assert_params_close(tr, tr.trainable, s2.params)
    if name == "ema":
        _assert_params_close(tr, tstate.ema, s2.ema_params)


def test_grad_accumulation_is_the_mean_of_micro_batches(setup):
    """grad_accum_steps=2 over a batch of 2 == the mean of the two
    micro-batches' gradients and metrics (accum 1 each, same draws)."""
    jd, params, td = setup
    batch = {k: torch.from_numpy(v) for k, v in _batch(jd, seed=12).items()}
    tr2 = Trainer(td, Schedule.create(SchedulerConfig()), TrainConfig(**CFG))
    tr2.init_state()
    tr1 = Trainer(td, Schedule.create(SchedulerConfig()),
                  TrainConfig(**CFG, grad_accum_steps=1))
    draws = [tr2.draw({"video_latents": batch["video_latents"][i:i + 1]},
                      torch.Generator().manual_seed(i)) for i in range(2)]
    g2, m2 = tr2.grads_and_metrics(batch, draws)
    parts = [tr1.grads_and_metrics({k: v[i:i + 1] for k, v in batch.items()}, [draws[i]])
             for i in range(2)]
    for k, g in g2.items():
        mean = (parts[0][0][k] + parts[1][0][k]) / 2
        assert float((g - mean).abs().max()) <= 1e-6 * max(1.0, float(mean.abs().max())), k
    for k, v in m2.items():
        assert _rel(v, (parts[0][1][k] + parts[1][1][k]) / 2) < 1e-6, k


def test_remat_groups_give_the_same_gradients(setup):
    """Per-group checkpointing (with the joint attention's outputs kept,
    "save_attn", or the nested per-block one) recomputes the forward in the
    backward: the same loss and gradients as without."""
    jd, params, _ = setup
    batch = {k: torch.from_numpy(v) for k, v in _batch(jd, seed=13).items()}
    results = []
    for remat, policy in ((False, None), (True, None), (True, "save_attn"), (True, "nested")):
        td = DiT.tiny(device="cpu", lora_rank=4, remat=remat, remat_policy=policy)
        td.load_state_dict(jax_params_to_torch(params), strict=True)
        tr = Trainer(td, Schedule.create(SchedulerConfig()), TrainConfig(**CFG))
        tr.init_state()
        results.append(tr.grads_and_metrics(batch, [tr.draw(
            {"video_latents": batch["video_latents"][i:i + 1]},
            torch.Generator().manual_seed(i)) for i in range(2)]))
    (g0, m0) = results[0]
    for g, m in results[1:]:
        assert _rel(m["loss"], m0["loss"]) < 1e-6
        for k in g0:
            assert float((g[k] - g0[k]).abs().max()) <= 1e-5 * max(1.0, float(g0[k].abs().max()))


def test_mute_token_dropout_matches_jax(setup):
    """Single-track audio with deterministic=False: the mute tokens go
    through dropout 0.1.  JAX's keep mask is read off its own outputs (with
    non-zero tokens, kept elements differ from the deterministic context by
    tok / 9 and dropped ones by -tok) and handed to the port."""
    jd, params, td = setup
    a = jd.audio_cfg
    rng = np.random.default_rng(14)
    n_af = jd.cfg.sample_frames + a.window_size - a.window_stride
    audio = rng.standard_normal((1, 1, n_af, a.blocks, a.audio_dim)).astype(np.float32)
    mute = rng.standard_normal((n_af, a.blocks, a.audio_dim)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, params)
    kw = dict(audio_embeds=jnp.asarray(audio), mute_embeds=jnp.asarray(mute))
    _, det = jd.prepare_conditioning(jp, **kw)
    _, drop = jd.prepare_conditioning(jp, **kw, deterministic=False,
                                      rngs={"dropout": jax.random.key(3)})
    tok = np.asarray(params["audio_statics"]["mute_learnable_tokens"])[0]
    diff = np.asarray(drop - det)[0, 1, 0]                       # [ctx, audio_dim]
    keep = np.abs(diff - tok / 9.0) < np.abs(diff + tok)
    assert 0.8 < keep.mean() < 0.97
    with torch.no_grad():
        _, got = td.prepare_conditioning(
            audio_embeds=torch.from_numpy(audio), mute_embeds=torch.from_numpy(mute),
            deterministic=False, dropout_keep=torch.from_numpy(keep[None]))
    scale = float(np.abs(np.asarray(drop)).max())
    assert float(np.abs(got.numpy() - np.asarray(drop)).max()) < 1e-5 * scale

"""A 2-layer DiT at the head dims the flash kernels took last (16, 256, and
32 with heads that do not pair), against the JAX package on the CPU, fp32.

The cases, and the attention path each takes on the card:
  * 8 heads of 16 (hpb 8: the flat B7 path; audio only: the face path's
    widths need an inner dim whose 2/3 splits into the router's 4 heads);
  * 6 heads of 16 (the tiny tier's heads: B11 and B12 + B13 on the bshd
    view, face + audio);
  * 3 heads of 32 (they do not pair in 128 lanes: bshd, face + audio);
  * 2 heads of 256 (hpb 1: flat, audio only).
At inference (`fuse_qk_norm`) none takes the fused B1: JAX's module takes
it only at head dims 32, 64 and 128 with heads that pack.

For each, on the plain versions (what a CPU tensor takes):
  * the inference forward against JAX's `DiT.apply`, within 1e-5 of the
    output's magnitude (the routing logits 1e-5 absolute);
  * the train step's gradients and metrics (`Trainer.grads_and_metrics` of
    2 micro-batches on JAX's draws, what `train_step` computes before its
    update) against JAX's jitted `_grads_and_metrics`: loss and metrics
    within 1e-4 relative, the gradients together within relative L2 1e-5,
    each tensor within 1e-4 (a key bias, whose true gradient is 0, against
    its query twin's norm), as `tests/test_torch_head_dims.py` holds its
    12 x 32 and 3 x 128 cases, whose optimizer updates it also compares.
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
from bindyouravatar_tpu_torch.convert import jax_params_to_torch
from bindyouravatar_tpu_torch.models.dit import DiT
from bindyouravatar_tpu_torch.ops.scheduler import Schedule
from bindyouravatar_tpu_torch.training.trainer import Trainer
from test_torch_train_slice import _batch, jax_draws
from torch_port_utils import max_err, realistic, threads_per_worker, to_torch

# case -> (heads, head dim, face path on)
CASES = {"8x16": (8, 16, False), "6x16": (6, 16, True), "3x32": (3, 32, True),
         "2x256": (2, 256, False)}
CFG = dict(learning_rate=1e-3, lr_warmup_steps=0, max_train_steps=10)
FACE_KEYS = ("id_cond", "id_vit_hidden", "teacher_clean", "teacher_noisy")


@pytest.fixture(autouse=True, scope="module")
def _threads():
    with threads_per_worker():
        yield


def _rel(got, want) -> float:
    return max_err(got, want) / float(np.abs(np.asarray(want)).max())


def _dits(case, fuse: bool):
    heads, d, face = CASES[case]
    kw = dict(num_attention_heads=heads, attention_head_dim=d, num_layers=2, lora_rank=4,
              is_train_face=face)
    jd = JDiT.tiny(fuse_qk_norm=fuse, **kw)
    params = realistic(jax.eval_shape(jd.init, jax.random.key(0)), seed=6)
    td = DiT.tiny(device="cpu", fuse_qk_norm=fuse, **kw)
    td.load_state_dict(jax_params_to_torch(params), strict=True)
    return jd, params, td


@pytest.mark.parametrize("case", list(CASES))
def test_dit_inference_forward_matches_jax(case):
    """The inference path (`fuse_qk_norm=True`) of the 2-layer DiT against
    JAX's `DiT.apply`."""
    jd, params, td = _dits(case, fuse=True)
    c, a, lf = jd.cfg, jd.audio_cfg, jd.lfe_cfg
    rng = np.random.default_rng(7)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    n_af = c.sample_frames + a.window_size - a.window_stride
    x = (f(1, c.latent_frames, c.in_channels, c.sample_height, c.sample_width),
         f(1, c.max_text_seq_length, c.text_embed_dim), np.array([321.0], np.float32))
    cond = dict(audio_embeds=f(1, 2, n_af, a.blocks, a.audio_dim))
    if CASES[case][2]:
        cond.update(id_cond=f(1, c.num_ids, lf.id_embed_dim),
                    id_vit_hidden=f(1, c.num_ids, lf.num_scales, 6, lf.vit_dim))
    rope = jd.rope(c.sample_height * 8, c.sample_width * 8, c.latent_frames)
    want, want_r = jax.jit(lambda p: jd.apply(p, *map(jnp.asarray, x), rope,
                                              **{k: jnp.asarray(v)
                                                 for k, v in cond.items()}))(params)
    with torch.no_grad():
        got, got_r = td.apply(*to_torch(*x),
                              td.rope(c.sample_height * 8, c.sample_width * 8, c.latent_frames),
                              **{k: to_torch(v)[0] for k, v in cond.items()})
    assert _rel(got, np.asarray(want)) < 1e-5
    if want_r is not None:
        assert max_err(got_r, np.asarray(want_r)) < 1e-5


@pytest.mark.parametrize("case", list(CASES))
def test_dit_train_step_matches_jax(case):
    """The train step's gradients and metrics (2 micro-batches) against
    JAX's on the same params, batch and draws."""
    jd, params, td = _dits(case, fuse=False)
    jcfg = JTrainConfig(**CFG)
    base = jtrainer.Trainer(dit=jd, schedule=JSchedule.create(JSchedulerConfig()), cfg=jcfg)
    batch = _batch(jd)
    if not CASES[case][2]:
        batch = {k: v for k, v in batch.items() if k not in FACE_KEYS}
    state, frozen = base.init_state(jax.tree.map(jnp.asarray, params))
    jgrads, jm = jax.jit(base._grads_and_metrics)(
        state.params, frozen, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(5))
    tr = Trainer(td, Schedule.create(SchedulerConfig()), TrainConfig(**CFG))
    grads, tm = tr.grads_and_metrics({k: torch.from_numpy(v) for k, v in batch.items()},
                                     jax_draws(jcfg, batch, jax.random.key(5), 2))
    assert set(tm) == set(jm)
    for k in jm:
        assert abs(float(tm[k]) - float(jm[k])) <= 1e-4 * max(abs(float(jm[k])), 1e-6), k
    want = jax_params_to_torch(jax.tree.map(np.asarray, jgrads))
    assert set(want) == set(grads)
    key_bias = ("to_k.bias", "norm_k.bias")
    for k, g in grads.items():
        ref = want[k.replace("_k.bias", "_q.bias")] if k.endswith(key_bias) else want[k]
        rel = float((g - want[k]).norm()) / max(float(ref.norm()), 1e-30)
        assert rel <= 1e-4, (k, rel)
    rest = [k for k in grads if not k.endswith(key_bias)]
    diff = sum(float((grads[k] - want[k]).double().square().sum()) for k in rest)
    norm = sum(float(want[k].double().square().sum()) for k in rest)
    assert (diff / norm) ** 0.5 <= 1e-5

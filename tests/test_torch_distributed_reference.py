"""The one-rank Stage-3 steps that `tests/test_torch_distributed.py` holds
its sharded steps to, against the JAX package's own two steps, on the CPU.

The same configuration (tiny DiT with LoRA r256, AdamW, EMA 0.9, a batch of
8 in 2 micro-batches, the masked diffusion loss), the same converted params
and batch, and JAX's draws (keys 5 and 6) handed to the port.  JAX's
`Trainer.train_step` is jitted whole, as its training loop runs it.
Tolerances: each step's loss within 1e-4 relative
(`tests/test_torch_train_slice.py`'s bound); the change of the trainable
tensors and of the EMA within relative L2 1e-4 of JAX's (5.8e-6 measured).
Not element by element: at a batch of 8 a few elements' gradients sit ~500x
below their tensor's median, and Adam's normalised step carries their fp32
rounding (1.2e-3 of the learning rate at
`router_trunk.st_1.multi_id_attn.to_q.weight`).  The attention key biases
are held apart, within 2 learning rates, as in the sharded test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bindyouravatar_tpu.config import SchedulerConfig as JSchedulerConfig
from bindyouravatar_tpu.config import TrainConfig as JTrainConfig
from bindyouravatar_tpu.ops.scheduler import Schedule as JSchedule
from bindyouravatar_tpu.training import trainer as jtrainer
from bindyouravatar_tpu_torch.convert import jax_params_to_torch
from test_torch_distributed import (KEY_BIAS, KEYS, LR, TRAIN_CFG, make_inputs, make_jax_inputs,
                                    one_rank_steps, rel_change)
from torch_port_utils import threads_per_worker


@pytest.fixture(autouse=True, scope="module")
def _threads():
    with threads_per_worker():
        yield


@pytest.fixture(scope="module")
def jax_inputs():
    return make_jax_inputs()


@pytest.fixture(scope="module")
def one_rank(jax_inputs):
    return one_rank_steps(make_inputs(jax_inputs))


@pytest.fixture(scope="module")
def jax_steps(jax_inputs):
    """JAX's two train steps (keys 5 and 6) on the same params and batch:
    the state after them and each step's loss."""
    jd, params, batch = jax_inputs
    jtr = jtrainer.Trainer(dit=jd, schedule=JSchedule.create(JSchedulerConfig()),
                           cfg=JTrainConfig(**TRAIN_CFG))
    state, frozen = jtr.init_state(jax.tree.map(jnp.asarray, params))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    step = jax.jit(jtr.train_step)
    losses = []
    for key in KEYS:
        state, m = step(state, frozen, jbatch, jax.random.key(key))
        losses.append(float(m["loss"]))
    return state, losses


def test_one_rank_losses_match_jax(one_rank, jax_steps):
    _, got = one_rank
    _, losses = jax_steps
    for g, w in zip(got["loss"], losses):
        assert abs(g - w) / max(abs(w), 1e-6) < 1e-4, (got["loss"], losses)


@pytest.mark.parametrize("kind", ["params", "ema"])
def test_one_rank_steps_match_jax(one_rank, jax_steps, kind):
    before, got = one_rank
    state, _ = jax_steps
    want = jax_params_to_torch(jax.tree.map(
        np.asarray, state.params if kind == "params" else state.ema_params))
    assert set(want) == set(got[kind])
    names = [k for k in want if not KEY_BIAS.match(k)]
    assert rel_change(got[kind], want, before, names) < 1e-4
    for k in want:
        if KEY_BIAS.match(k):
            assert (got[kind][k] - want[k]).abs().max() <= 2 * LR, k

"""`ops/ff.py:ff_chunked` and `ops/layernorm.py:lean_layernorm` against the
JAX package's, on the CPU in fp32: values and VJPs within 1e-5 of the
largest magnitude (S not a multiple of the chunk count); and a tiny DiT's
train step at `ff_chunks=3` against `ff_chunks=1` (the same function, its
sums chunked: loss within 1e-6 relative, each gradient within relative L2
1e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bindyouravatar_tpu.ops.ff import ff_chunked as jff_chunked
from bindyouravatar_tpu.ops.layernorm import lean_layernorm as jlean_layernorm
from bindyouravatar_tpu_torch.config import SchedulerConfig, TrainConfig
from bindyouravatar_tpu_torch.models.dit import DiT
from bindyouravatar_tpu_torch.models.layers import FeedForward
from bindyouravatar_tpu_torch.ops.ff import ff_chunked
from bindyouravatar_tpu_torch.ops.layernorm import layernorm_plain, lean_layernorm
from bindyouravatar_tpu_torch.ops.scheduler import Schedule
from bindyouravatar_tpu_torch.training.trainer import Trainer
from torch_port_utils import max_err, threads_per_worker


@pytest.fixture(autouse=True, scope="module")
def _threads():
    with threads_per_worker():
        yield


def _rel(got, want) -> float:
    return max_err(got, want) / float(np.abs(np.asarray(want)).max())


@pytest.mark.parametrize("s,chunks", [(37, 4), (40, 3), (9, 1)])
def test_ff_chunked_matches_jax(s, chunks):
    """Forward and the VJP of every input (x and the four parameters; JAX's
    kernels [in, out], the port's weights [out, in])."""
    rng = np.random.default_rng(s)
    d, dh = 24, 96
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    x, w0, b0, w2, b2, dy = f(2, s, d), f(d, dh) * 0.2, f(dh), f(dh, d) * 0.1, f(d), f(2, s, d)
    y, vjp = jax.vjp(lambda *a: jff_chunked(*a, chunks), *map(jnp.asarray, (x, w0, b0, w2, b2)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(dy))]
    t = [torch.from_numpy(a).requires_grad_() for a in (x, w0.T.copy(), b0, w2.T.copy(), b2)]
    got = ff_chunked(*t, chunks)
    assert _rel(got.detach(), y) < 1e-5
    got.backward(torch.from_numpy(dy))
    grads = [t[0].grad, t[1].grad.T, t[2].grad, t[3].grad.T, t[4].grad]
    for g, w in zip(grads, want):
        assert _rel(g, w) < 1e-5


@pytest.mark.parametrize("frozen", [(1, 2, 3, 4), (1, 3), (0,)])
def test_ff_chunked_computes_only_the_gradients_asked_for(frozen):
    """Inputs without `requires_grad` (a frozen FF under LoRA training, or
    a constant x) get no gradient; the others equal those of the run where
    every input takes one."""
    rng = np.random.default_rng(5)
    d, dh = 24, 96
    f = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    args = [f(2, 37, d), 0.2 * f(dh, d), f(dh), 0.1 * f(d, dh), f(d)]
    dy = f(2, 37, d)
    full = [a.clone().requires_grad_() for a in args]
    ff_chunked(*full, 4).backward(dy)
    part = [a.clone().requires_grad_(i not in frozen) for i, a in enumerate(args)]
    y = ff_chunked(*part, 4)
    assert torch.equal(y.detach(), ff_chunked(*args, 4))
    y.backward(dy)
    for i, (a, b) in enumerate(zip(part, full)):
        if i in frozen:
            assert a.grad is None
        else:
            assert torch.equal(a.grad, b.grad), i


def test_feed_forward_chunks_is_the_plain_mlp():
    """`FeedForward(chunks=3)` computes `FeedForward()`'s function on the same
    parameters (names unchanged), values and gradients."""
    torch.manual_seed(0)
    plain = FeedForward(16, compute_dtype=torch.float32)
    chunked = FeedForward(16, chunks=3, compute_dtype=torch.float32)
    chunked.load_state_dict(plain.state_dict(), strict=True)
    x = torch.randn(2, 11, 16)
    y0, y1 = plain(x), chunked(x)
    assert float((y0 - y1).abs().max()) < 1e-5
    (y0.square().sum() + y1.square().sum()).backward()
    for (k, p), q in zip(plain.named_parameters(), chunked.parameters()):
        assert float((p.grad - q.grad).abs().max()) <= 1e-5 * float(p.grad.abs().max()), k


@pytest.mark.parametrize("shape", [(3, 7, 64), (5, 40)])
def test_lean_layernorm_matches_jax(shape):
    """Value and VJP (x, scale, bias) against JAX's `lean_layernorm`; the
    value equals the plain LayerNorm's."""
    rng = np.random.default_rng(len(shape))
    d = shape[-1]
    x = (3.0 + rng.standard_normal(shape)).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(d)).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    y, vjp = jax.vjp(lambda *a: jlean_layernorm(*a, 1e-5), *map(jnp.asarray, (x, scale, bias)))
    want = [np.asarray(v) for v in vjp(jnp.asarray(g))]
    t = [torch.from_numpy(a).requires_grad_() for a in (x, scale, bias)]
    got = lean_layernorm(*t)
    assert _rel(got.detach(), y) < 1e-5
    assert torch.equal(got.detach(), layernorm_plain(*[a.detach() for a in t]))
    got.backward(torch.from_numpy(g))
    for a, w in zip(t, want):
        assert _rel(a.grad, w) < 1e-5


def test_dit_train_step_at_ff_chunks_3_equals_ff_chunks_1():
    """One micro-batch's loss and every trainable gradient of the tiny DiT
    (LoRA r4, face + audio) at `ff_chunks=3` against `ff_chunks=1`, the same
    weights, batch and draws."""
    from test_torch_train_slice import _batch

    from bindyouravatar_tpu.models.dit import DiT as JDiT

    batch = {k: torch.from_numpy(v[:1]) for k, v in _batch(JDiT.tiny(lora_rank=4)).items()}
    gen = torch.Generator().manual_seed(0)
    base = DiT.tiny(device="cpu", generator=gen, lora_rank=4)
    runs = []
    for chunks in (1, 3):
        dit = DiT.tiny(device="cpu", lora_rank=4, ff_chunks=chunks)
        dit.load_state_dict(base.state_dict(), strict=True)
        assert dit.blocks[0].ff.chunks == chunks
        tr = Trainer(dit, Schedule.create(SchedulerConfig()),
                     TrainConfig(grad_accum_steps=1, lr_warmup_steps=1))
        tr.init_state()
        draws = [tr.draw(batch, torch.Generator().manual_seed(1))]
        runs.append(tr.grads_and_metrics(batch, draws))
    (g1, m1), (g3, m3) = runs
    assert abs(float(m3["loss"]) - float(m1["loss"])) <= 1e-6 * abs(float(m1["loss"]))
    for k, g in g1.items():
        ref = g1[k.replace("_k.bias", "_q.bias")] if k.endswith("to_k.bias") else g
        assert float((g3[k] - g).norm()) <= 1e-5 * max(float(ref.norm()), 1e-30), k

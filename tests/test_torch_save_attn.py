"""The port's `remat_policy="save_attn"` against the JAX package's, on the
CPU, in fp32.

- Gradients: `DiT.tiny(lora_rank=4, remat=True, remat_policy="save_attn")`
  of the port against JAX's with the same policy on the converted weights,
  every parameter's gradient of one loss (the output weighted by a fixed
  numpy draw), on three attention paths: the default tiny DiT (6 heads of
  16, 8 + 288 rows: JAX's XLA attention below 1,024 rows, `sdpa` here),
  2 heads of 48 (they pair in 128 lanes: the flat B7 path) and the default
  heads at 8 + 1,152 rows (the bshd B11 path).  fp32 on both sides, sums in
  another order: 1e-4 of each gradient's largest magnitude.  The attention
  key biases are held to their query biases' magnitude instead: softmax is
  invariant to them, so their true gradient is 0 and both sides hold fp32
  rounding noise there.
- Forward counts: the joint attention's forward runs once per block
  under "save_attn", twice without a policy (the forward and the group
  recompute) and three times under "nested" (and the block's own
  recompute); on both kernel paths, counted on the CPU path (the plain
  versions).  A second backward through a kept region (`retain_graph=True`)
  replays the kept outputs again and gives the same gradients.
- JAX's own "save_attn" names only the attention output: its recompute
  still reruns the flash forward for the LSE that its backward needs.  The
  port keeps the LSE too (the intent of JAX `config.py:69-72`, "the flash
  forward never recomputes"); the gradients are the same function.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint
from jax.ad_checkpoint import checkpoint_name
from jax.extend.core import ClosedJaxpr, Jaxpr

from bindyouravatar_tpu.models.dit import DiT as JDiT
from bindyouravatar_tpu.ops.flash_attention import flash_attention as jflash_attention
from bindyouravatar_tpu_torch.convert import jax_params_to_torch
from bindyouravatar_tpu_torch.models.dit import DiT
from bindyouravatar_tpu_torch.ops import flash_attention as tfa
from torch_port_utils import realistic, threads_per_worker, to_torch

# attention path -> tiny DiT overrides
PATHS = {
    "sdpa": {},
    "flat": dict(num_attention_heads=2, attention_head_dim=48),
    "bshd": dict(sample_height=32, sample_width=48),
}


@pytest.fixture(autouse=True, scope="module")
def _threads():
    """Torch's threads at this xdist worker's share of the cores."""
    with threads_per_worker():
        yield


def _inputs(jd, seed):
    """Numpy inputs of one face + audio forward at batch 2, and the loss
    weights for its output."""
    c, a, lf = jd.cfg, jd.audio_cfg, jd.lfe_cfg
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    n_af = c.sample_frames + a.window_size - a.window_stride
    args = (f(2, c.latent_frames, c.in_channels, c.sample_height, c.sample_width),
            f(2, c.max_text_seq_length, c.text_embed_dim), np.array([999.0, 499.0], np.float32))
    cond = dict(id_cond=f(2, c.num_ids, lf.id_embed_dim),
                id_vit_hidden=f(2, c.num_ids, lf.num_scales, 6, lf.vit_dim),
                audio_embeds=f(2, 2, n_af, a.blocks, a.audio_dim))
    w = f(2, c.latent_frames, c.out_channels, c.sample_height, c.sample_width)
    return args, cond, w


def _port_grads(td, jd, args, cond, w):
    c = jd.cfg
    rope = tuple(to_torch(*jd.rope(c.sample_height * 8, c.sample_width * 8, c.latent_frames)))
    out, _ = td.apply(*to_torch(*args), rope, **{k: to_torch(v)[0] for k, v in cond.items()})
    (out * to_torch(w)[0]).sum().backward()
    return {k: p.grad for k, p in td.named_parameters() if p.grad is not None}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_save_attn_gradients_match_jax(path):
    jd = JDiT.tiny(lora_rank=4, remat=True, remat_policy="save_attn", **PATHS[path])
    c = jd.cfg
    params = realistic(jax.eval_shape(jd.init, jax.random.key(0)), seed=60)
    args, cond, w = _inputs(jd, 61)
    rope = jd.rope(c.sample_height * 8, c.sample_width * 8, c.latent_frames)

    def loss(p):
        out, _ = jd.apply(p, *map(jnp.asarray, args), rope,
                          **{k: jnp.asarray(v) for k, v in cond.items()})
        return (out * jnp.asarray(w)).sum()

    want = jax_params_to_torch(jax.grad(loss)(params))
    td = DiT.tiny(device="cpu", lora_rank=4, remat=True, remat_policy="save_attn", **PATHS[path])
    td.load_state_dict(jax_params_to_torch(params), strict=True)
    got = _port_grads(td, jd, args, cond, w)
    assert set(got) <= set(want) and len(got) > 0.9 * len(want)
    for k, g in got.items():
        ref = k.replace("to_k.bias", "to_q.bias") if k.endswith("to_k.bias") else k
        scale = max(float(want[ref].abs().max()), 1e-6)
        assert float((g - want[k]).abs().max()) <= 1e-4 * scale, k


@pytest.mark.parametrize("path,forward", [("flat", "flash_attention_flat_fwd"),
                                          ("bshd", "flash_attention_fwd")])
def test_joint_attention_forward_runs_once_per_block(path, forward, monkeypatch):
    """Calls of the joint attention's forward (the plain version on the
    CPU) over one forward and backward, per policy; the policies'
    gradients agree."""
    calls = []
    real = getattr(tfa, forward)
    monkeypatch.setattr(tfa, forward, lambda *a, **k: calls.append(1) or real(*a, **k))
    jd = JDiT.tiny(lora_rank=4, **PATHS[path])
    params = jax_params_to_torch(realistic(jax.eval_shape(jd.init, jax.random.key(0)), seed=62))
    args, cond, w = _inputs(jd, 63)
    counts, grads = {}, {}
    for remat, policy in ((False, None), (True, None), (True, "save_attn"), (True, "nested")):
        td = DiT.tiny(device="cpu", lora_rank=4, remat=remat, remat_policy=policy, **PATHS[path])
        td.load_state_dict(params, strict=True)
        calls.clear()
        grads[remat, policy] = _port_grads(td, jd, args, cond, w)
        counts[remat, policy] = len(calls)
    n = jd.cfg.num_layers
    assert counts == {(False, None): n, (True, None): 2 * n, (True, "save_attn"): n,
                      (True, "nested"): 3 * n}
    g0 = grads[False, None]
    for g in grads.values():
        for k in g0:
            assert float((g[k] - g0[k]).abs().max()) <= 1e-5 * max(1.0, float(g0[k].abs().max()))


@pytest.mark.parametrize("layout", ["flat", "bshd"])
def test_kept_outputs_replay_on_every_backward(layout, monkeypatch):
    """Two backwards through one checkpointed region with a tagged
    attention: the forward runs once, and both backwards' gradients equal
    those of the region without checkpointing."""
    forward = "flash_attention_flat_fwd" if layout == "flat" else "flash_attention_fwd"
    calls = []
    real = getattr(tfa, forward)
    monkeypatch.setattr(tfa, forward, lambda *a, **k: calls.append(1) or real(*a, **k))
    rng = np.random.default_rng(64)
    h, d = 2, 64
    shape = (1, 40, h * d) if layout == "flat" else (1, 40, h, d)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).requires_grad_()
    attend = (functools.partial(tfa.flash_attention_flat, heads=h) if layout == "flat" else
              functools.partial(tfa.flash_attention, layout="bshd"))

    def region(x):
        return attend(x * 0.5, x.sin(), x.cos(), name="attn_out").tanh()

    want = torch.autograd.grad(region(x).sum(), x)[0]
    calls.clear()
    loss = checkpoint(region, x, use_reentrant=False,
                      context_fn=functools.partial(tfa.keep_attention, "attn_out")).sum()
    for _ in range(2):
        got = torch.autograd.grad(loss, x, retain_graph=True)[0]
        assert torch.equal(got, want)
    assert len(calls) == 1


def _pallas_forwards(jaxpr: Jaxpr) -> int:
    """The flash forward kernels (pallas_calls with two outputs, o and the
    LSE; the backward has three) in a jaxpr and its sub-jaxprs."""
    n = 0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "pallas_call" and len(eqn.params["out_avals"]) == 2:
            n += 1
        for p in eqn.params.values():
            for sub in p if isinstance(p, (list, tuple)) else (p,):
                if isinstance(sub, ClosedJaxpr):
                    n += _pallas_forwards(sub.jaxpr)
                elif isinstance(sub, Jaxpr):
                    n += _pallas_forwards(sub)
    return n


def test_jax_save_attn_reruns_the_flash_forward():
    """JAX's policy keeps the output named "attn_out" but not the flash
    custom vjp's LSE residual: the gradient of a checkpointed flat flash
    attention (the Pallas kernels in interpret mode) holds two forward
    kernels under "save_attn" as under no policy, and one without remat."""
    b, s, h, d = 1, 256, 2, 64

    def body(x, w):
        o = jflash_attention(x @ w[0], x @ w[1], x @ w[2], layout="flat", heads=h,
                             interpret=True)
        return jnp.tanh(checkpoint_name(o, "attn_out") @ w[3])

    x = jnp.ones((b, s, h * d), jnp.bfloat16)
    w = jnp.full((4, h * d, h * d), 0.01, jnp.bfloat16)
    save_attn = jax.checkpoint_policies.save_only_these_names("attn_out")
    counts = {}
    for name, f in (("none", body), ("remat", jax.checkpoint(body)),
                    ("save_attn", jax.checkpoint(body, policy=save_attn))):
        loss = lambda x_, w_, f=f: f(x_, w_).astype(jnp.float32).sum()
        counts[name] = _pallas_forwards(jax.make_jaxpr(jax.grad(loss, argnums=(0, 1)))(x, w).jaxpr)
    assert counts == {"none": 1, "remat": 2, "save_attn": 2}

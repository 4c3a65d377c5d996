"""The flash attention entry points' dispatch against the JAX package's, on
the CPU, in fp32.

- Flat attention under grad takes the differentiable B7 path
  (`flash_attention_flat`, the counterpart of JAX's `_flash_flat`), the
  inference path B1 otherwise; the fused QK-LN forms, which have no
  backward (none in JAX either), raise under grad.  The choice is the one
  `kernel_path` makes for a call on the card; the CPU's plain versions
  cannot show it, so it is checked by name.
- `DiT` raises on a checkpointing policy the port does not implement
  instead of running it as no policy.
- `attention` follows JAX's rule: the flash kernels from 1,024 rows with
  as many kv rows as q rows, else the XLA math (`sdpa` after the QK-LN
  and RoPE).  Held against JAX `attention` at Sq != Skv and at S < 1,024
  with the same numpy inputs; fp32 on both sides, 1e-5 of each output's
  largest magnitude (sums in another order).  The rule itself is shown on
  meta tensors, which only the plain math computes: the kernel wrappers
  raise for them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bindyouravatar_tpu.ops import attention as jattn
from bindyouravatar_tpu.ops.rope import get_3d_rotary_pos_embed as jrope
from bindyouravatar_tpu_torch.models.dit import REMAT_POLICIES, DiT
from bindyouravatar_tpu_torch.ops import attention as tattn
from bindyouravatar_tpu_torch.ops import flash_attention as tfa
from torch_port_utils import max_err, to_torch


def _rel(got, want) -> float:
    return max_err(got, want) / float(np.abs(np.asarray(want)).max())


def _qk_norm(rng, d):
    return tuple(to_torch(*(rng.standard_normal(d).astype(np.float32) * 0.1 + m
                            for m in (1.0, 0.0, 1.0, 0.0))))


# ------------------------------------------------------- flat under grad
@pytest.mark.parametrize("layout", ["flat", "bhsd"])
def test_kernel_path_under_grad(layout):
    """q, k, v that require grad, with grad enabled: flat goes to B7, the
    general layouts to B11 (with B12 + B13 behind it); under no_grad, or
    with inputs that need no grad, flat goes to B1."""
    q, k, v = (torch.zeros(1, 8, 128, requires_grad=True) for _ in range(3))
    want = {"flat": "B7", "bhsd": "B11"}[layout]
    assert tfa.kernel_path(tfa.wants_grad(q, k, v), None, layout) == want
    with torch.no_grad():
        assert tfa.kernel_path(tfa.wants_grad(q, k, v), None, layout) == want.replace("B7", "B1")
    plain = [t.detach() for t in (q, k, v)]
    assert tfa.kernel_path(tfa.wants_grad(*plain), None, layout) == want.replace("B7", "B1")


@pytest.mark.parametrize("layout", ["flat", "bhsd", "bshd"])
def test_fused_qk_norm_raises_under_grad(layout):
    """A fused QK-LN call under grad raises, whether q/k/v or the LN's
    affines need the gradient; under no_grad it is the inference kernel."""
    norm = _qk_norm(np.random.default_rng(0), 64)
    q, k, v = (torch.zeros(1, 8, 128, requires_grad=True) for _ in range(3))
    with pytest.raises(ValueError, match="inference only"):
        tfa.kernel_path(tfa.wants_grad(q, k, v, *norm), norm, layout)
    affine = [norm[0].clone().requires_grad_(), *norm[1:]]
    plain = [t.detach() for t in (q, k, v)]
    with pytest.raises(ValueError, match="inference only"):
        tfa.kernel_path(tfa.wants_grad(*plain, *affine), affine, layout)
    with torch.no_grad():
        got = tfa.kernel_path(tfa.wants_grad(q, k, v, *affine), affine, layout)
    assert got == ("B1" if layout == "flat" else "B11")


def test_flat_grad_path_matches_jax_attention_gradients():
    """The B7 path's autograd wiring (`_FlashFlat`, the function
    `flash_attention_flat` applies on the card, whose forward and backward
    take their plain versions for CPU tensors) against
    `jax.vjp` of JAX `attention(layout="flat")` (its XLA path below 1,024
    rows), with RoPE from a text offset: values and q/k/v gradients."""
    import jax

    b, s, h, d, text_len = 1, 96, 2, 64, 6
    cos, sin = jrope(d, ((0, 0), (4, 5)), (4, 5), 4)
    rng = np.random.default_rng(60)
    q, k, v, do = (rng.standard_normal((b, s, h * d)).astype(np.float32) for _ in range(4))
    f = lambda q_, k_, v_: jattn.attention(q_, k_, v_, rope=(cos, sin), rope_start=text_len,
                                           layout="flat", heads=h)
    want, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    qkv = [t.requires_grad_() for t in to_torch(q, k, v)]
    rope = tuple(to_torch(np.asarray(cos), np.asarray(sin)))
    out = tfa._FlashFlat.apply(*qkv, h, None, None, rope, text_len)
    grads = torch.autograd.grad(out, qkv, torch.from_numpy(do))
    assert _rel(out, want) < 1e-5
    for g, w in zip(grads, vjp(jnp.asarray(do))):
        assert _rel(g, w) < 1e-4


# ------------------------------------------------------------ remat policy
@pytest.mark.parametrize("policy", ["dots"])
def test_unported_remat_policy_raises(policy):
    """A policy the port does not implement raises under remat, naming
    what is ported ("save_attn" among them); without remat the policy is
    not read, as in JAX."""
    with pytest.raises(NotImplementedError, match="save_attn"):
        DiT.tiny(device="cpu", remat=True, remat_policy=policy)
    DiT.tiny(device="cpu", remat=False, remat_policy=policy)
    for ok in REMAT_POLICIES:
        DiT.tiny(device="cpu", remat=True, remat_policy=ok)


# ------------------------------------------------------ attention dispatch
ATTENTION_CASES = [
    # layout, Sq, Skv, kv_len, RoPE, QK-LN
    ("bhsd", 160, 96, None, True, False),
    ("bhsd", 96, 160, 150, True, True),
    ("bhsd", 1040, 520, None, False, True),
    ("bshd", 200, 72, 70, False, False),
    ("bhsd", 512, 512, 500, True, True),
    ("flat", 512, 512, 500, True, True),
    ("flat", 300, 300, None, False, False),
]


@pytest.mark.parametrize("layout,sq,skv,kv_len,rope,ln", ATTENTION_CASES)
def test_attention_matches_jax_off_the_kernel_rule(layout, sq, skv, kv_len, rope, ln):
    """`attention` where JAX takes its XLA path (Sq != Skv, or fewer than
    1,024 rows) against JAX `attention` on the same inputs."""
    b, h, d, text_len = 2, 2, 64, 6
    rng = np.random.default_rng(sq * 7 + skv)
    shape = lambda s: {"flat": (b, s, h * d), "bhsd": (b, h, s, d), "bshd": (b, s, h, d)}[layout]
    q = rng.standard_normal(shape(sq)).astype(np.float32)
    k, v = (rng.standard_normal(shape(skv)).astype(np.float32) for _ in range(2))
    kw = dict(kv_len=kv_len, layout=layout, heads=h if layout == "flat" else None)
    jkw, tkw = dict(kw), dict(kw)
    if rope:
        cos, sin = jrope(d, ((0, 0), (4, 5)), (4, 5), 3)      # 60 rows from row 6
        jkw.update(rope=(cos, sin), rope_start=text_len)
        tkw.update(rope=tuple(to_torch(np.asarray(cos), np.asarray(sin))), rope_start=text_len)
    if ln:
        norm = _qk_norm(rng, d)
        jkw["qk_norm"] = tuple(jnp.asarray(t.numpy()) for t in norm)
        tkw["qk_norm"] = norm
    want = jattn.attention(*map(jnp.asarray, (q, k, v)), **jkw)
    got = tattn.attention(*to_torch(q, k, v), **tkw)
    assert got.shape == q.shape
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("layout", ["flat", "bhsd", "bshd"])
def test_attention_takes_the_kernels_from_1024_rows(layout):
    """On tensors that no kernel takes (meta), the call that meets JAX's
    rule (S >= 1,024, Sq == Skv) reaches a kernel wrapper, which raises;
    a shorter one, or one with another kv length, runs the plain math and
    returns the output's shape."""
    meta = lambda s, d=64: torch.empty(
        {"flat": (1, s, 2 * d), "bhsd": (1, 2, s, d), "bshd": (1, s, 2, d)}[layout],
        device="meta")
    kw = dict(layout=layout, heads=2 if layout == "flat" else None)
    with pytest.raises(ValueError, match="flash_attention kernel"):
        tattn.attention(meta(1024), meta(1024), meta(1024), **kw)
    with pytest.raises(ValueError, match="flash_attention kernel"):   # a head dim no kernel takes
        tattn.attention(meta(1024, 80), meta(1024, 80), meta(1024, 80), **kw)
    assert tattn.attention(meta(1000), meta(1000), meta(1000), **kw).shape == meta(1000).shape
    assert tattn.attention(meta(1024), meta(2048), meta(2048), **kw).shape == meta(1024).shape

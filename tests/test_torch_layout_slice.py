"""The slice's model branch against the JAX package, on the CPU, in fp32:
the DiT's joint attention on the training path with heads that do not pack
two per 128 lanes (JAX `layers.py:354-373`), which takes the bshd attention
(B11 forward, B12/B13 backward on the card), and the layout dispatch of
`attention`.

Realistic-scale weights (`torch_port_utils.realistic`) and numpy inputs go
to both frameworks.  3 heads of 64 with 16 text + 1,024 video tokens, so
the JAX module takes its flash branch (`use_flash=True`, 1,040 tokens padded
to 2,048 and masked) while the port runs the unpadded sequence.  fp32 on
both sides: 1e-5 relative to the output's magnitude, 1e-4 for the
gradients (sums over 1,040 rows in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bindyouravatar_tpu.models.layers import JointSelfAttention as JJointSelfAttention
from bindyouravatar_tpu.ops import attention as jattn
from bindyouravatar_tpu.ops.rope import get_3d_rotary_pos_embed as jrope
from bindyouravatar_tpu_torch.convert import jax_params_to_torch
from bindyouravatar_tpu_torch.models.layers import HeadLayerNorm, JointSelfAttention
from bindyouravatar_tpu_torch.ops import attention as tattn
from bindyouravatar_tpu_torch.ops import flash_attention as tfa
from bindyouravatar_tpu_torch.ops import layernorm as tln
from torch_port_utils import max_err, realistic, to_torch


def _rel(got, want) -> float:
    return max_err(got, want) / float(np.abs(np.asarray(want)).max())


@pytest.fixture(scope="module")
def unpaired():
    """JAX's output and every parameter's gradient of sum(out * w) for one
    `JointSelfAttention` (3 x 64 heads, LoRA r4 with B non-zero, dim 96)."""
    heads, dh, dim, text_len, grid = 3, 64, 96, 16, (4, 16, 16)
    cos, sin = jrope(dh, ((0, 0), grid[1:]), grid[1:], grid[0])
    rng = np.random.default_rng(50)
    hidden = rng.standard_normal((1, cos.shape[0], dim)).astype(np.float32)
    enc = rng.standard_normal((1, text_len, dim)).astype(np.float32)
    w_h = rng.standard_normal(hidden.shape).astype(np.float32)
    w_e = rng.standard_normal(enc.shape).astype(np.float32)
    jm = JJointSelfAttention(heads=heads, head_dim=dh, use_flash=True, lora_rank=4,
                             lora_alpha=8.0, dtype=jnp.float32)
    rope = (cos, sin)
    params = realistic(jax.eval_shape(jm.init, jax.random.key(0), jnp.asarray(hidden),
                                      jnp.asarray(enc), rope)["params"], seed=51)

    def loss(p):
        oh, oe = jm.apply({"params": p}, jnp.asarray(hidden), jnp.asarray(enc), rope)
        return (oh * w_h).sum() + (oe * w_e).sum(), (oh, oe)

    (_, outs), grads = jax.value_and_grad(loss, has_aux=True)(params)
    return dict(heads=heads, dh=dh, dim=dim, params=params, hidden=hidden, enc=enc, w_h=w_h,
                w_e=w_e, rope=tuple(to_torch(np.asarray(cos), np.asarray(sin))), outs=outs,
                grads=jax_params_to_torch(grads))


def test_unpaired_heads_take_the_bshd_attention(unpaired, monkeypatch):
    """3 heads of 64 do not pair in 128 lanes: the training path calls the
    general-layout attention with the [B, S, H, D] view, never the flat B7
    attention; 12 heads of 64 stay flat.  At 16 + 1,024 rows, so that
    `attention`'s dispatch rule (flash from 1,024 rows) takes the kernel
    path."""
    calls = []
    real = tfa.flash_attention_layout
    monkeypatch.setattr(tfa, "flash_attention_layout",
                        lambda *a, **k: calls.append(a[3]) or real(*a, **k))
    monkeypatch.setattr("bindyouravatar_tpu_torch.models.layers.flash_attention_flat",
                        lambda *a, **k: calls.append("flat") or tfa.flash_attention_flat(*a, **k))
    for heads in (3, 12):
        tm = JointSelfAttention(unpaired["dim"], heads, 64, compute_dtype=torch.float32)
        tm(*to_torch(unpaired["hidden"], unpaired["enc"]), None)
    assert calls == ["bshd", "flat"]


def test_unpaired_joint_attention_matches_jax(unpaired):
    """Output (video and text parts) and the gradient of every parameter
    (projections, biases, QK norms, LoRA A and B) vs the JAX module on its
    flash branch."""
    u = unpaired
    tm = JointSelfAttention(u["dim"], u["heads"], u["dh"], lora_rank=4, lora_alpha=8.0,
                            compute_dtype=torch.float32)
    tm.load_state_dict(jax_params_to_torch(u["params"]), strict=True)
    oh, oe = tm(*to_torch(u["hidden"], u["enc"]), u["rope"])
    for got, want in zip((oh, oe), u["outs"]):
        assert _rel(got, want) < 1e-5
    ((oh * torch.from_numpy(u["w_h"])).sum() + (oe * torch.from_numpy(u["w_e"])).sum()).backward()
    assert set(u["grads"]) == {n for n, _ in tm.named_parameters()}
    for name, p in tm.named_parameters():
        want = u["grads"][name].numpy()
        if name == "to_k.bias":      # softmax is invariant to it: both sides hold rounding noise
            assert max_err(p.grad, want) < 1e-4
            continue
        assert _rel(p.grad, want) < 1e-4, name


@pytest.mark.parametrize("layout", ["flat", "bhsd", "bshd"])
def test_attention_layout_dispatch_matches_jax(layout):
    """`attention(layout=...)` with RoPE from a text offset and a masked kv
    tail vs JAX `attention` (its XLA path) on the same layout."""
    b, h, s, d, text_len = 2, 2, 96, 64, 6
    cos, sin = jrope(d, ((0, 0), (4, 5)), (4, 5), 4)
    rng = np.random.default_rng(52)
    shape = {"flat": (b, s, h * d), "bhsd": (b, h, s, d), "bshd": (b, s, h, d)}[layout]
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    kw = dict(kv_len=90, rope_start=text_len, layout=layout,
              heads=h if layout == "flat" else None)
    want = jattn.attention(*map(jnp.asarray, (q, k, v)), rope=(cos, sin), **kw)
    got = tattn.attention(*to_torch(q, k, v), rope=tuple(to_torch(np.asarray(cos),
                                                                  np.asarray(sin))), **kw)
    assert got.shape == shape
    assert _rel(got, want) < 1e-5


def test_head_layernorm_dispatch_by_width():
    """The op `head_layernorm` (and `HeadLayerNorm` through it) sends every
    CUDA-side call to kernel B10's wrapper, also where the JAX op's shape
    rule (`ops/layernorm.py:309-313`) leaves its kernel for XLA math: 15
    heads of 64 (960) and 16 heads (1,024) both reach the wrapper, which
    raises for meta tensors; a head dim the kernel does not take (12)
    raises naming its ROADMAP entry.  A CPU tensor takes the plain math at
    every width."""
    for heads, dh in ((15, 64), (16, 64), (5, 12)):
        norm = HeadLayerNorm(dh).to("meta")
        x = torch.empty((4, heads * dh), device="meta", dtype=torch.bfloat16)
        match = "queue B item 3" if dh % 8 else "bf16 CUDA rows"
        for fn in (norm, lambda t: tln.head_layernorm(t, norm.weight, norm.bias)):
            with pytest.raises(ValueError, match=match):
                fn(x)
        cpu = HeadLayerNorm(dh)
        assert cpu(torch.zeros((4, heads * dh))).shape == (4, heads * dh)

"""The training path's kernel ops, losses and schedule functions against
the JAX package, on the CPU, in fp32.

Each new kernel's plain version (the path a CPU tensor takes) is held
against the Pallas body it replaces, run in interpret mode as the JAX
package's own tests run it: B7 forward and backward through
`jax.value_and_grad` of `flash_attention(layout="flat", interpret=True)`
(RoPE from a text offset, a masked kv tail), B8 through
`_tiny_bwd_pallas(interpret=True)`, B9 and B10 through `pl.pallas_call`
of `_ln_bwd_kernel`, `_hln_fwd_kernel` and `_hln_bwd_kernel` (a row grid
that does not divide the rows).  Inputs are made with numpy.  fp32 on both
sides: 1e-5 relative to each output's magnitude, 1e-4 for the sums over
rows (dscale, dbias) and the LSE.
"""

import ast
import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from bindyouravatar_tpu.config import SchedulerConfig as JSchedulerConfig
from bindyouravatar_tpu.models.layers import JointSelfAttention as JJointSelfAttention
from bindyouravatar_tpu.ops import flash_attention as jfa
from bindyouravatar_tpu.ops import layernorm as jln
from bindyouravatar_tpu.ops import packed_attention as jpa
from bindyouravatar_tpu.ops.rope import get_3d_rotary_pos_embed as jrope
from bindyouravatar_tpu.ops.scheduler import Schedule as JSchedule
from bindyouravatar_tpu.training import losses as JL
from bindyouravatar_tpu_torch.config import SchedulerConfig
from bindyouravatar_tpu_torch.convert import jax_params_to_torch
from bindyouravatar_tpu_torch.models.layers import JointSelfAttention
from bindyouravatar_tpu_torch.ops import flash_attention as tfa
from bindyouravatar_tpu_torch.ops import layernorm as tln
from bindyouravatar_tpu_torch.ops import packed_attention as tpa
from bindyouravatar_tpu_torch.ops.autograd import kernel_with_plain_vjp
from bindyouravatar_tpu_torch.ops.scheduler import Schedule
from bindyouravatar_tpu_torch.training import losses as TL
from torch_port_utils import max_err, realistic, to_torch

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _rel(got, want) -> float:
    return max_err(got, want) / float(np.abs(np.asarray(want)).max())


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# --------------------------------------------------------------------- B7
def _b7_case():
    """q/k/v [1, 256, 2*64] with RoPE on rows 8..247 (3 x 8 x 10 video
    tokens after 8 text tokens) and kv rows >= 248 masked."""
    b, h, d, text_len = 1, 2, 64, 8
    cos, sin = jrope(d, ((0, 0), (8, 10)), (8, 10), 3)
    s_real = text_len + cos.shape[0]
    s = 256
    rng = np.random.default_rng(31)
    q, k, v = (_normal(rng, b, s, h * d) for _ in range(3))
    return dict(b=b, h=h, d=d, s=s, s_real=s_real, text_len=text_len,
                rope=(np.asarray(cos), np.asarray(sin)), q=q, k=k, v=v)


def test_b7_plain_forward_and_backward_match_flat_kernels_interpret():
    """B7's plain forward (output, LSE) and plain backward (dq, dk, dv from
    dO, LSE and delta) vs the TPU flat kernels: `jax.value_and_grad` of
    `flash_attention(layout="flat", interpret=True)` (the `_flash_flat`
    custom vjp: `_fwd_flat_kernel` saving the LSE, `_bwd_flat_kernel`)."""
    c = _b7_case()
    h, s_real, text_len = c["h"], c["s_real"], c["text_len"]
    cos, sin = (jnp.asarray(t) for t in c["rope"])

    def flat_loss(q, k, v):
        o = jfa.flash_attention(q, k, v, layout="flat", heads=h, kv_len=s_real,
                                rope=(cos, sin), rope_start=text_len,
                                block_q=128, block_k=128, interpret=True)
        return (o[:, :s_real] ** 2).sum(), o

    (_, o_want), grads = jax.value_and_grad(flat_loss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(c[n]) for n in "qkv"))
    # the LSE residual the forward kernel saves (compact [B, H/2, 2, S])
    d, s = c["d"], c["s"]
    tail = s - text_len - cos.shape[0]
    pad = lambda t, fill: jnp.concatenate([jnp.full((text_len, d), fill), t,
                                           jnp.full((tail, d), fill)])
    _, lse_want = jfa._fwd_flat_impl(*(jnp.asarray(c[n]) for n in "qkv"), h,
                                     (pad(cos, 1.0), pad(sin, 0.0)), d ** -0.5, s_real, 128, 128,
                                     True, save_residuals=True)
    lse_want = np.asarray(lse_want).reshape(c["b"], h, s)

    q, k, v = to_torch(c["q"], c["k"], c["v"])
    rope = tuple(to_torch(*c["rope"]))
    o, lse = tfa.flash_attention_flat_fwd(q, k, v, h, kv_len=s_real, rope=rope,
                                          rope_start=text_len)
    assert _rel(o, o_want) < 1e-5
    assert max_err(lse, lse_want) < 1e-4
    do = 2 * o * (torch.arange(s) < s_real)[None, :, None]
    got = tfa.flash_attention_flat_bwd(q, k, v, do, lse, tfa.attention_delta(o, do, h), h,
                                       kv_len=s_real, rope=rope, rope_start=text_len)
    for g, w in zip(got, grads):
        assert _rel(g, w) < 1e-5


def test_b7_autograd_function_matches_autograd_of_plain_forward():
    """`flash_attention_flat`'s autograd Function (the CUDA path's wiring:
    forward with the LSE, delta = rowsum(o dO), the explicit backward) run
    on CPU tensors, where each half takes its plain version, against
    autograd through the plain forward."""
    c = _b7_case()
    h, s_real, text_len = c["h"], c["s_real"], c["text_len"]
    rope = tuple(to_torch(*c["rope"]))
    w = torch.from_numpy(_normal(np.random.default_rng(32), c["b"], c["s"], h * c["d"]))
    grads = []
    for fn in (lambda *a: tfa._FlashFlat.apply(*a, h, None, s_real, rope, text_len),
               lambda *a: tfa.flash_attention_flat_fwd_plain(*a, h, kv_len=s_real, rope=rope,
                                                             rope_start=text_len)[0]):
        qkv = [t.requires_grad_() for t in to_torch(c["q"], c["k"], c["v"])]
        grads.append(torch.autograd.grad((fn(*qkv) * w).sum(), qkv))
    for g, want in zip(*grads):
        assert _rel(g, want.numpy()) < 1e-5


# --------------------------------------------------------------------- B8
@pytest.mark.parametrize("m,s", [(132, 13), (40, 8)])
def test_b8_plain_matches_slice_bwd_kernel_interpret(m, s):
    """B8's plain version vs `_slice_bwd_kernel` through
    `_tiny_bwd_pallas(interpret=True)` (132 rows: a partial row block)."""
    heads, dh = 4, 32
    rng = np.random.default_rng(33)
    q, k, v, g = (_normal(rng, m, s, heads * dh) for _ in range(4))
    want = jpa._tiny_bwd_pallas(*map(jnp.asarray, (q, k, v, g)), heads, dh ** -0.5,
                                interpret=True)
    got = tpa.tiny_seq_attention_bwd(*to_torch(q, k, v, g), heads, dh ** -0.5)
    for a, b in zip(got, want):
        assert _rel(a, b) < 1e-5


def test_plain_vjp_function_matches_autograd():
    """`kernel_with_plain_vjp` (the backward of B2, B3, B4, B5' and of B5
    below 8 frames): its gradients equal autograd through the plain
    version, the routing weights' included, and None where not needed."""
    from bindyouravatar_tpu_torch.ops.short_kv_attention import (
        short_kv_attention_combined_flat_plain as plain)
    rng = np.random.default_rng(34)
    q, k, v, w = to_torch(_normal(rng, 2, 12, 2 * 16), _normal(rng, 2, 2, 2, 4, 16),
                          _normal(rng, 2, 2, 2, 4, 16), rng.uniform(size=(2, 12, 2)))
    gout = torch.from_numpy(_normal(rng, 2, 12, 32))
    leaves = [t.requires_grad_() for t in (q, k, v, w)]
    want = torch.autograd.grad((plain(*leaves, 0.25) * gout).sum(), leaves)
    leaves2 = [t.detach().requires_grad_() for t in (q, k, v, w)]
    got = torch.autograd.grad(
        (kernel_with_plain_vjp(plain, plain, leaves2, (0.25,)) * gout).sum(), leaves2)
    for a, b in zip(got, want):
        assert torch.allclose(a, b)
    # only q needs a gradient: the others are left out of the recompute's grad
    q_only = q.detach().requires_grad_()
    out = kernel_with_plain_vjp(plain, plain, (q_only, k.detach(), v.detach(), w.detach()),
                                (0.25,))
    assert torch.allclose(torch.autograd.grad((out * gout).sum(), q_only)[0], want[0])


# ---------------------------------------------------------------- B9, B10
def _pallas_rows(kernel, inputs, m, c, rows, n_out):
    nb = -(-m // rows)
    spec = pl.BlockSpec((rows, c), lambda i: (i, 0))
    vspec = pl.BlockSpec((1, c), lambda i: (0, 0))
    pspec = pl.BlockSpec((8, c), lambda i: (0, 0))
    if n_out == 1:
        return pl.pallas_call(kernel, grid=(nb,), in_specs=[spec, vspec, vspec],
                              out_specs=spec,
                              out_shape=jax.ShapeDtypeStruct((m, c), jnp.float32),
                              interpret=True)(*inputs)
    return pl.pallas_call(kernel, grid=(nb,), in_specs=[spec, vspec, spec],
                          out_specs=[spec, pspec, pspec],
                          out_shape=[jax.ShapeDtypeStruct((m, c), jnp.float32),
                                     jax.ShapeDtypeStruct((8, c), jnp.float32),
                                     jax.ShapeDtypeStruct((8, c), jnp.float32)],
                          interpret=True)(*inputs)


@pytest.mark.parametrize("m,d", [(19, 256), (8, 384)])
def test_b9_plain_matches_ln_bwd_kernel_interpret(m, d):
    """B9's plain version (the closed form) vs `_ln_bwd_kernel` (the row
    LN backward), the partial row sums folded as `_ln_bwd_pallas` does."""
    rng = np.random.default_rng(35)
    x, g = 2.0 * _normal(rng, m, d) + 0.5, _normal(rng, m, d)
    scale = 1.0 + 0.2 * _normal(rng, d)
    dx, dsp, dbp = _pallas_rows(functools.partial(jln._ln_bwd_kernel, eps=1e-5, m=m, rows=8),
                                (jnp.asarray(x), jnp.asarray(scale).reshape(1, d),
                                 jnp.asarray(g)), m, d, 8, 3)
    got = tln.layernorm_bwd(*to_torch(x, scale, g))
    assert _rel(got[0], dx) < 1e-5
    assert _rel(got[1], jnp.sum(dsp, 0)) < 1e-4
    assert _rel(got[2], jnp.sum(dbp, 0)) < 1e-4


@pytest.mark.parametrize("m,h", [(20, 2), (13, 3)])
def test_b10_plain_matches_head_ln_kernels_interpret(m, h):
    """B10's plain forward and backward vs `_hln_fwd_kernel` /
    `_hln_bwd_kernel` (64-wide head segments, affine shared across heads;
    the backward's partial sums folded over rows, then heads)."""
    dh, eps = 64, 1e-6
    c = h * dh
    rng = np.random.default_rng(36)
    x, g = 2.0 * _normal(rng, m, c) - 0.3, _normal(rng, m, c)
    scale, bias = 1.0 + 0.2 * _normal(rng, dh), 0.2 * _normal(rng, dh)
    tile = lambda t: jnp.tile(jnp.asarray(t), h).reshape(1, c)
    want_y = _pallas_rows(functools.partial(jln._hln_fwd_kernel, eps=eps, dh=dh),
                          (jnp.asarray(x), tile(scale), tile(bias)), m, c, 8, 1)
    dx, dsp, dbp = _pallas_rows(functools.partial(jln._hln_bwd_kernel, eps=eps, dh=dh, m=m,
                                                  rows=8),
                                (jnp.asarray(x), tile(scale), jnp.asarray(g)), m, c, 8, 3)
    xt, st, bt, gt = to_torch(x, scale, bias, g)
    assert _rel(tln.head_layernorm_fwd(xt, st, bt, eps), want_y) < 1e-5
    got = tln.head_layernorm_bwd(xt, st, gt, eps)
    assert _rel(got[0], dx) < 1e-5
    assert _rel(got[1], jnp.sum(dsp, 0).reshape(h, dh).sum(0)) < 1e-4
    assert _rel(got[2], jnp.sum(dbp, 0).reshape(h, dh).sum(0)) < 1e-4
    # the autograd Function's wiring, on CPU tensors (plain halves)
    xg, sg, bg = (t.clone().requires_grad_() for t in (xt, st, bt))
    fn_grads = torch.autograd.grad((tln._HeadLayerNorm.apply(xg, sg, bg, eps) * gt).sum(),
                                   (xg, sg, bg))
    for a, b in zip(fn_grads, got):
        assert torch.allclose(a, b, atol=1e-5)


# ------------------------------------------------------------ the module
@pytest.mark.parametrize("fuse", [False, True])
def test_joint_attention_lora_matches_jax(fuse):
    """`JointSelfAttention` with LoRA r4 (to_q/to_k adapters, B non-zero)
    on both paths, the training one (B10 QK norms, then B7 with RoPE from
    the text length) and the fused inference one (B1), vs the JAX module
    (`use_flash=False`: its plain XLA path)."""
    heads, dh, dim, text_len = 2, 64, 96, 5
    cos, sin = jrope(dh, ((0, 0), (3, 4)), (3, 4), 2)
    rng = np.random.default_rng(37)
    hidden, enc = _normal(rng, 2, cos.shape[0], dim), _normal(rng, 2, text_len, dim)
    jm = JJointSelfAttention(heads=heads, head_dim=dh, use_flash=False, lora_rank=4,
                             lora_alpha=8.0, dtype=jnp.float32)
    params = realistic(jax.eval_shape(jm.init, jax.random.key(0), jnp.asarray(hidden),
                                      jnp.asarray(enc), (cos, sin))["params"], seed=38)
    want = jm.apply({"params": params}, jnp.asarray(hidden), jnp.asarray(enc), (cos, sin))
    tm = JointSelfAttention(dim, heads, dh, lora_rank=4, lora_alpha=8.0, fuse_qk_norm=fuse,
                            compute_dtype=torch.float32)
    tm.load_state_dict(jax_params_to_torch(params), strict=True)
    with torch.no_grad():
        got = tm(*to_torch(hidden, enc), tuple(to_torch(np.asarray(cos), np.asarray(sin))))
    for a, b in zip(got, want):
        assert _rel(a, b) < 1e-5


# ------------------------------------------------------- losses, schedule
def _routing(rng, grid, layers=3, b=2):
    t, h, w = grid
    return rng.uniform(0, 1, (layers, b, t * h * w, 2)).astype(np.float32)


@pytest.mark.parametrize("compat", [True, False])
def test_routing_losses_match_jax(compat):
    grid = (3, 8, 12)
    rng = np.random.default_rng(39)
    r = _routing(rng, grid)
    r[r < 0.05] = 0.0                     # values under the 0.01 side threshold
    teacher = (rng.uniform(size=r.shape[1:]) > 0.5).astype(np.float32)
    jr, tr = jnp.asarray(r), torch.from_numpy(r)
    pairs = [(JL.routing_bce_loss(jr, jnp.asarray(teacher)),
              TL.routing_bce_loss(tr, torch.from_numpy(teacher))),
             (JL.consistency_loss(jr), TL.consistency_loss(tr))]
    for name in ("temporal_diff_loss", "spatial_diff_loss", "spatial_distribution_loss",
                 "id_distribution_loss"):
        pairs.append((getattr(JL, name)(jr, grid, compat), getattr(TL, name)(tr, grid, compat)))
    for want, got in pairs:
        assert abs(float(got) - float(want)) <= 1e-5 * max(1.0, abs(float(want)))
    assert float(TL.consistency_loss(tr[:1])) == 0.0
    p, t = rng.uniform(size=50).astype(np.float32), rng.uniform(size=50).astype(np.float32)
    assert max_err(TL.focal_loss(torch.from_numpy(p), torch.from_numpy(t)),
                   JL.focal_loss(jnp.asarray(p), jnp.asarray(t))) < 1e-6


@pytest.mark.parametrize("mask", [None, "grid", "full"])
def test_diffusion_loss_and_schedule_match_jax(mask):
    """`add_noise`, `get_velocity`, `loss_weight` and the (masked)
    v-prediction loss vs JAX, timesteps across the table."""
    rng = np.random.default_rng(40)
    shape = (3, 2, 4, 6, 8)
    x0, noise, out = (_normal(rng, *shape) for _ in range(3))
    t = np.array([0, 517, 999], np.int32)
    js, ts = JSchedule.create(JSchedulerConfig()), Schedule.create(SchedulerConfig())
    tt = torch.from_numpy(t).long()
    noisy_w = js.add_noise(jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(t))
    noisy = ts.add_noise(*to_torch(x0, noise), tt)
    assert max_err(noisy, noisy_w) < 1e-6
    assert max_err(ts.get_velocity(*to_torch(noise, x0), tt),
                   js.get_velocity(jnp.asarray(noise), jnp.asarray(x0), jnp.asarray(t))) < 1e-6
    assert max_err(ts.loss_weight(tt), js.loss_weight(jnp.asarray(t))) < 1e-6 * 1e3
    m = None
    if mask == "grid":
        m = (rng.uniform(size=(3, 2, 6, 8)) > 0.5).astype(np.float32)
    elif mask == "full":
        m = (rng.uniform(size=shape) > 0.5).astype(np.float32)
    want = JL.diffusion_loss(jnp.asarray(out), noisy_w, jnp.asarray(x0), jnp.asarray(t), js,
                             None if m is None else jnp.asarray(m))
    got = TL.diffusion_loss(torch.from_numpy(out), noisy, torch.from_numpy(x0), tt, ts,
                            None if m is None else torch.from_numpy(m))
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))


# ----------------------------------------------------------- self-contained
def test_port_imports_neither_jax_nor_the_jax_package():
    """No module of the port, and not `chip_smoke.py`, imports `jax`,
    `flax`, `optax`, `bindyouravatar_tpu` (the port keeps its own copies
    of what it needs) or `safetensors` (the card's machine lacks it: the
    port reads the format itself, `utils/safetensors.py`)."""
    banned = ("jax", "flax", "optax", "bindyouravatar_tpu", "safetensors")
    files = sorted((ROOT / "bindyouravatar_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    # the training and serving entry points' modules and the encoders' are among them
    names = {str(p.relative_to(ROOT)) for p in files}
    assert {f"bindyouravatar_tpu_torch/{m}.py" for m in (
        "utils/masks", "training/data", "training/checkpoint", "training/train_loop",
        "training/sft", "training/trainer", "models/vae", "convert", "infer",
        "serving/server", "pipeline/pipeline", "utils/media", "preprocess/audio",
        # the conditioning encoders and the face stack
        "models/t5", "models/eva_clip", "preprocess/arcface", "preprocess/retinaface",
        "preprocess/bisenet", "preprocess/face",
        # the two-stage generate, the upscaler and the batch front end
        "models/sam2", "preprocess/sam2_video", "tools/sam2_tools", "models/rrdbnet",
        "utils/upscale", "utils/cfg_files", "tools/batch_run_samples",
        # the readers of reference-format weights
        "utils/safetensors", "training/import_submodules", "training/import_encoders",
        # the optimizers, the validation hook, the chunked FF and the wav2vec2 extractor
        "training/adafactor", "training/prodigy", "training/adam8bit", "training/validation",
        "ops/ff", "preprocess/wav2vec2",
        # distribution and the profiling helpers
        "parallel/mesh", "parallel/sharding", "parallel/tp", "ops/ring_attention",
        "utils/profiling")} <= names
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in banned, f"{path.name} imports {n}"

"""The train step's two redesigned backward kernels, B8 (tiny-sequence
attention backward, on the tensor cores) and B9 (row LayerNorm backward,
CUDA C++ with its dscale/dbias fold in the same launch), on the CPU.

The kernels run only on the card (`chip_smoke.py` phase 2 holds them
against their plain versions there, at ragged shapes and run twice for a
bitwise repeat).  Here the plain versions, which a CPU tensor takes, are
held against the Pallas bodies they replace, run in interpret mode as the
JAX package's own tests run them, at the shapes the new kernels treat
apart: B8 at S = 9 and 16 (the kernel pads S to a 16-row tile; the train
ops file covers 8 and 13) and at 17, 25, 33 and 64 (the long body's), B9 at D = 128 and 640 (one chunk a thread, and
a thread's last chunk empty) with ragged row counts, one of them below the
Pallas row block.  fp32 on both sides: 1e-5 of each output's magnitude,
1e-4 for the sums over rows.  Then the profiler groups that read the new
kernels' device time, and the smoke's record of B9's route.
"""

import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import pallas as pl

from bindyouravatar_tpu.ops import layernorm as jln
from bindyouravatar_tpu.ops import packed_attention as jpa
from bindyouravatar_tpu_torch import profile_step
from bindyouravatar_tpu_torch.ops import layernorm as tln
from bindyouravatar_tpu_torch.ops import packed_attention as tpa
from torch_port_utils import max_err, to_torch

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _rel(got, want) -> float:
    return max_err(got, want) / float(np.abs(np.asarray(want)).max())


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("m,s,heads,dh", [
    *(pytest.param(m, s, 2, 64, id=f"{m}-{s}")
      for m, s in ((131, 9), (20, 16), (20, 17), (20, 25), (20, 33), (20, 64))),
    (20, 13, 16, 32), (20, 13, 8, 48), (20, 13, 4, 128), (20, 25, 4, 128)])
def test_b8_plain_matches_slice_bwd_kernel_interpret(m, s, heads, dh):
    """B8's plain version vs `_slice_bwd_kernel` through
    `_tiny_bwd_pallas(interpret=True)`, 2 heads of 64 (131 rows at S = 9:
    two row blocks of 128, the second partial); past 16 rows, the long
    body's lengths: 25 (97 frames), 17 and 33 (one row into a second and a
    third tile) and 64; and the STAB's other head splits (16 x 32, 8 x 48,
    4 x 128), at 49 frames and, at dh 128, 97."""
    rng = np.random.default_rng(81)
    q, k, v, g = (_normal(rng, m, s, heads * dh) for _ in range(4))
    want = jpa._tiny_bwd_pallas(*map(jnp.asarray, (q, k, v, g)), heads, dh ** -0.5,
                                interpret=True)
    got = tpa.tiny_seq_attention_bwd(*to_torch(q, k, v, g), heads, dh ** -0.5)
    for a, b in zip(got, want):
        assert a.shape == (m, s, heads * dh)
        assert _rel(a, b) < 1e-5


def _ln_bwd_interpret(x, scale, g, eps, rows=8):
    """`_ln_bwd_kernel` over a row grid of `rows`-row blocks (the last one
    partial), its per-block partial sums folded as `_ln_bwd_pallas` does."""
    m, d = x.shape
    spec = pl.BlockSpec((rows, d), lambda i: (i, 0))
    vspec = pl.BlockSpec((1, d), lambda i: (0, 0))
    pspec = pl.BlockSpec((8, d), lambda i: (0, 0))
    dx, dsp, dbp = pl.pallas_call(
        functools.partial(jln._ln_bwd_kernel, eps=eps, m=m, rows=rows),
        grid=(-(-m // rows),), in_specs=[spec, vspec, spec], out_specs=[spec, pspec, pspec],
        out_shape=[jax.ShapeDtypeStruct((m, d), jnp.float32),
                   jax.ShapeDtypeStruct((8, d), jnp.float32),
                   jax.ShapeDtypeStruct((8, d), jnp.float32)],
        interpret=True)(jnp.asarray(x), jnp.asarray(scale).reshape(1, d), jnp.asarray(g))
    return dx, jnp.sum(dsp, 0), jnp.sum(dbp, 0)


@pytest.mark.parametrize("m,d", [(5, 128), (21, 128), (13, 640)])
def test_b9_plain_matches_ln_bwd_kernel_interpret(m, d):
    """B9's plain version (the closed form) vs `_ln_bwd_kernel`: 5 rows
    (fewer than one row block: its `valid` mask zeroes the rest), 21 and 13
    (a partial last block)."""
    rng = np.random.default_rng(82)
    x, g = 2.3 * _normal(rng, m, d) + 0.7, _normal(rng, m, d)
    scale = 1.0 + 0.1 * _normal(rng, d)
    dx, ds, db = _ln_bwd_interpret(x, scale, g, 1e-5)
    got = tln.layernorm_bwd(*to_torch(x, scale, g))
    assert got[0].shape == (m, d) and got[1].shape == got[2].shape == (d,)
    assert _rel(got[0], dx) < 1e-5
    assert _rel(got[1], ds) < 1e-4
    assert _rel(got[2], db) < 1e-4


@pytest.mark.parametrize("kernel,group", [
    ("void (anonymous namespace)::layernorm_bwd_kernel<3>(__nv_bfloat16 const*, float const*, "
     "__nv_bfloat16 const*, __nv_bfloat16*, float*, float*, unsigned int*, int, int, int, "
     "float)", "B9 LayerNorm backward"),
    ("_ZN45_GLOBAL__N__40822dc9_12_layernorm_cu_c77912a520layernorm_bwd_kernelILi2EEEvPK13"
     "__nv_bfloat16PKfS3_PS1_PfS7_Pjiiif", "B9 LayerNorm backward"),
    ("ln_bwd_kernel", "B10 LayerNorm backward"),
    ("ln_fwd_kernel", "B10 LayerNorm forward"),
    ("void (anonymous namespace)::layernorm_rows_kernel<3>(__nv_bfloat16 const*, float const*, "
     "float const*, __nv_bfloat16*, int, int, int, float)", "B6 LayerNorm forward"),
    ("void (anonymous namespace)::tiny_seq_bwd_kernel<13>(__nv_bfloat16 const*, "
     "__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16*, "
     "__nv_bfloat16*, __nv_bfloat16*, long long, int, float)",
     "B8 tiny_seq_attention backward"),
    ("(anonymous namespace)::tiny_seq_long_bwd_kernel(__nv_bfloat16 const*, "
     "__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16*, "
     "__nv_bfloat16*, __nv_bfloat16*, long long, int, int, float)",
     "B8 tiny_seq_attention backward"),
    ("(anonymous namespace)::tiny_seq_long_kernel(__nv_bfloat16 const*, __nv_bfloat16 const*, "
     "__nv_bfloat16 const*, __nv_bfloat16*, long long, int, int, float)",
     "B5 tiny_seq_attention"),
])
def test_train_profile_groups_name_each_backward(kernel, group):
    """`profile_step --train` reads B9's device time from its CUDA kernel's
    own group and B10's backward from the Triton `ln_bwd_kernel`'s; neither
    name falls into the other's group.  B5's and B8's long bodies (S > 16)
    count in B5's and B8's groups."""
    assert profile_step._group(kernel, profile_step.TRAIN_GROUPS) == group


def test_smoke_records_b9_as_the_cuda_kernel():
    """`chip_smoke.py`'s kernels line names B9's route and source as the
    CUDA kernel, which defines the entry point its wrapper calls; B10 stays
    Triton."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    route, source, replaces = smoke.KERNELS["B9"]
    assert (route, source) == ("cuda", "bindyouravatar_tpu_torch/csrc/layernorm.cu")
    assert replaces == "bindyouravatar_tpu/ops/layernorm.py:199"
    assert 'extern "C" int bya_layernorm_bwd(' in (ROOT / source).read_text()
    assert smoke.KERNELS["B10 bwd"][0] == "triton"

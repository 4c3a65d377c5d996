"""Shared helpers of the `test_torch_*` files: numpy-made inputs and
realistic-scale weights handed to both the JAX package and the torch port."""

import contextlib
import os

import jax
import numpy as np
import torch

# fp32 references on the CPU: no TF32 anywhere
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def realistic(params, seed: int = 0):
    """A numpy param tree shaped like `params` (arrays, or the
    ShapeDtypeStructs of `jax.eval_shape(module.init, ...)`) with weights at
    realistic scale: norm gains ~ N(1, 0.1), every other leaf ~ N(0, 0.1).
    At the init's ones/zeros, convention bugs (a swapped affine, a missing
    bias) hide."""
    rng = np.random.default_rng(seed)

    def draw(path, x):
        name = str(path[-1].key) if hasattr(path[-1], "key") else str(path[-1])
        mean = 1.0 if name == "scale" else 0.0
        return (mean + 0.1 * rng.standard_normal(x.shape)).astype(np.dtype(x.dtype))

    return jax.tree_util.tree_map_with_path(draw, params)


def to_torch(*arrays):
    return [torch.from_numpy(np.array(a, dtype=np.float32)) for a in arrays]


def max_err(got, want) -> float:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return float(np.abs(got.astype(np.float64) - np.asarray(want, np.float64)).max())


@contextlib.contextmanager
def threads_per_worker():
    """Torch's intra-op threads at this pytest-xdist worker's share of the
    cores, for a test module of small ops: with every worker's pool at all
    cores they spin against each other (a tiny CLI run beside two busy
    workers took 72 s instead of 10)."""
    n = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    try:
        yield
    finally:
        torch.set_num_threads(n)

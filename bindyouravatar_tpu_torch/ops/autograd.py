"""Gradients for kernels whose JAX twin has no Pallas backward.

The JAX package differentiates B2, B3, B4 and B5' (and B5 below 8 frames)
through the vjp of their plain XLA specs (`_bwd_a`, `_bwd_cf`, `_pair_bwd`,
`_packed_bwd`, `_tiny_bwd`).  `kernel_with_plain_vjp` does the same here:
the forward launches the kernel, the backward recomputes the plain PyTorch
version from the saved inputs and takes its vjp.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch


class _PlainVjp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kernel, plain, static, *tensors):
        ctx.save_for_backward(*tensors)
        ctx.plain, ctx.static = plain, static
        return kernel(*tensors, *static)

    @staticmethod
    def backward(ctx, g):
        tensors = ctx.saved_tensors
        need = ctx.needs_input_grad[3:]
        with torch.enable_grad():
            xs = [t.detach().requires_grad_(n) for t, n in zip(tensors, need)]
            out = ctx.plain(*xs, *ctx.static)
            wrt = [x for x, n in zip(xs, need) if n]
            grads = iter(torch.autograd.grad(out, wrt, g)) if wrt else iter(())
        return (None, None, None, *[next(grads) if n else None for n in need])


def kernel_with_plain_vjp(kernel: Callable, plain: Callable, tensors: Sequence[torch.Tensor],
                          static: tuple = ()) -> torch.Tensor:
    """kernel(*tensors, *static), differentiated through plain(*tensors,
    *static) recomputed in the backward."""
    return _PlainVjp.apply(kernel, plain, tuple(static), *tensors)

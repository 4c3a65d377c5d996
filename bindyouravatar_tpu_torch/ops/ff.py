"""Sequence-chunked feed-forward with a recompute backward (the port of
`bindyouravatar_tpu/ops/ff.py`).

`ff_chunked` computes the tanh-GELU MLP y = gelu(x w0^T + b0) w2^T + b2 over
chunks of the sequence (padded up to a multiple of the chunk count), and
its backward recomputes each chunk's `net_0` + GELU instead of keeping the
[S, 4 dim] intermediates, so the backward holds [S / chunks, 4 dim] of them
at a time: the single-card training-depth lever of `DiTConfig.ff_chunks`.
The parameters are cast to the activation dtype first and their gradients
are accumulated in fp32 (flax Dense's convention).  The products are
`torch.matmul`: JAX computes them outside any Pallas kernel.  Weights are
torch's [out, in] (`FeedForward`'s `net_0` and `net_2`).
"""

from __future__ import annotations

import math

import torch


def _pad(x: torch.Tensor, chunks: int):
    """x [B, S, D] padded with zero rows to a multiple of `chunks`, as
    [chunks, B, S / chunks, D]; and S."""
    b, s, d = x.shape
    sc = -(-s // chunks) * chunks
    if sc != s:
        x = torch.cat([x, x.new_zeros(b, sc - s, d)], dim=1)
    return x.reshape(b, chunks, sc // chunks, d).transpose(0, 1), s


def _gelu_grad(h: torch.Tensor) -> torch.Tensor:
    """d gelu_tanh / dh in fp32 (JAX `_ff_bwd`'s closed form)."""
    hf = h.float()
    c = math.sqrt(2.0 / math.pi)
    t = torch.tanh(c * (hf + 0.044715 * hf ** 3))
    return 0.5 * (1.0 + t) + 0.5 * hf * (1.0 - t * t) * c * (1.0 + 3 * 0.044715 * hf * hf)


class _FFChunked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w0, b0, w2, b2, chunks):
        dt = x.dtype
        w0c, b0c, w2c, b2c = (p.to(dt) for p in (w0, b0, w2, b2))
        xcs, s = _pad(x, chunks)
        ys = [torch.nn.functional.gelu(xc @ w0c.t() + b0c, approximate="tanh") @ w2c.t() + b2c
              for xc in xcs]
        ctx.save_for_backward(x, w0, b0, w2, b2)
        ctx.chunks = chunks
        return torch.stack(ys, 1).reshape(x.shape[0], -1, w2.shape[0])[:, :s]

    @staticmethod
    def backward(ctx, dy):
        x, w0, b0, w2, b2 = ctx.saved_tensors
        chunks, dt = ctx.chunks, x.dtype
        need_dx, need_dw0, need_db0, need_dw2, need_db2, _ = ctx.needs_input_grad
        w0c, b0c, w2c = (p.to(dt) for p in (w0, b0, w2))
        xcs, s = _pad(x, chunks)
        dycs, _ = _pad(dy.to(dt), chunks)

        def acc(p, need):
            # fp32 accumulators only for the gradients autograd asks for: a
            # frozen FF (LoRA training) gets none of the weight products
            return torch.zeros(p.shape, dtype=torch.float32, device=x.device) if need else None

        dw0, db0, dw2, db2 = (acc(w0, need_dw0), acc(b0, need_db0), acc(w2, need_dw2),
                              acc(b2, need_db2))
        dxs = []
        for xc, dyc in zip(xcs, dycs):
            # the chunk's intermediates again: the [S, 4 dim] tensors never
            # exist whole in the backward
            h = xc @ w0c.t() + b0c
            if dw2 is not None:
                a = torch.nn.functional.gelu(h, approximate="tanh")
                dw2 += torch.einsum("bsd,bso->od", a, dyc).float()
            if db2 is not None:
                db2 += dyc.sum((0, 1)).float()
            if not (need_dx or need_dw0 or need_db0):
                continue
            dh = ((dyc @ w2c).float() * _gelu_grad(h)).to(dt)
            if dw0 is not None:
                dw0 += torch.einsum("bsd,bso->od", xc, dh).float()
            if db0 is not None:
                db0 += dh.sum((0, 1)).float()
            if need_dx:
                dxs.append(dh @ w0c)
        dx = (torch.stack(dxs, 1).reshape(x.shape[0], -1, x.shape[-1])[:, :s].to(x.dtype)
              if need_dx else None)
        cast = lambda g, p: None if g is None else g.to(p.dtype)  # noqa: E731
        return dx, cast(dw0, w0), cast(db0, b0), cast(dw2, w2), cast(db2, b2), None


def ff_chunked(x: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor, w2: torch.Tensor,
               b2: torch.Tensor, chunks: int) -> torch.Tensor:
    """gelu_tanh(x w0^T + b0) w2^T + b2 over `chunks` sequence chunks.
    x [B, S, D] (any float dtype); w0 [Dh, D], b0 [Dh], w2 [D, Dh], b2 [D]."""
    return _FFChunked.apply(x, w0, b0, w2, b2, chunks)

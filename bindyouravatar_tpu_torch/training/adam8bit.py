"""Block-wise 8-bit AdamW (the port of the JAX package's
`training/adam8bit.py`, its counterpart of bitsandbytes' AdamW8bit).

Both moments are stored in 8 bits with one fp32 scale per block of 2,048
elements of the flattened tensor: the first moment as linear absmax int8
(-127..127), the second as uint8 of sqrt(v) / absmax (0..255), squared on
the way back.  One update, per tensor: dequantize, the Adam moments and
the bias-corrected step m_hat / (sqrt(v_hat) + eps), requantize; then
decoupled weight decay and the learning rate (JAX's `scale_by_adam8bit`,
`add_decayed_weights`, `scale_by_learning_rate`).  `torch.round` rounds half
to even, as `jnp.round` does.

Deliberate deviations, pinned by `tests/test_torch_optimizers.py`:
* The blocks follow each port tensor's own row-major order.  JAX's blocks
  run over its scan-stacked [L, ...] leaf, in flax's [in, out] orientation,
  so a block can span two layers; matching that would take a transposed,
  stacked copy of every trainable tensor at every step.  The math per block
  is JAX's bit for bit; the quantization error lands on other blocks.
* Every tensor is quantized, however small, as JAX does; bitsandbytes keeps
  tensors of fewer than 4,096 elements in fp32.

Under FSDP (`shards.py`) the blocks stay those of the whole tensor's
row-major order: each element of a rank's part finds its block from its
index in the whole tensor, a block's absmax is the max over the fsdp group
of the ranks' maxima over their elements of it (a block that straddles two
ranks' parts gets the scale the whole tensor gives it; FSDP2's padding is
no element of any part), and every rank keeps all the tensor's block scales.
So the codes and scales equal the unsharded ones, and a checkpoint saved at
any fsdp size restores at any other.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Tuple

import torch

from ..parallel.sharding import Part
from .shards import ShardAware

BLOCK = 2048


def _nblocks(n: int, block: int) -> int:
    return max(1, -(-n // block))


def _blocks(x: torch.Tensor, block: int) -> torch.Tensor:
    """x flattened, zero-padded to whole blocks, as [nblocks, block] fp32."""
    n = x.numel()
    flat = x.reshape(-1).float()
    pad = _nblocks(n, block) * block - n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, block)


def quantize_m(x: torch.Tensor, block: int = BLOCK) -> Tuple[torch.Tensor, torch.Tensor]:
    """Signed linear absmax int8 over blocks -> (q like x, scales [nblocks])."""
    xb = _blocks(x, block)
    s = xb.abs().amax(dim=1) / 127.0
    q = torch.round(xb / torch.clamp(s, min=1e-30)[:, None]).clamp_(-127, 127).to(torch.int8)
    return q.reshape(-1)[:x.numel()].reshape(x.shape), s


def dequantize_m(q: torch.Tensor, s: torch.Tensor, block: int = BLOCK) -> torch.Tensor:
    return (_blocks(q, block) * s[:, None]).reshape(-1)[:q.numel()].reshape(q.shape)


def quantize_v(x: torch.Tensor, block: int = BLOCK) -> Tuple[torch.Tensor, torch.Tensor]:
    """The second moment (x >= 0): uint8 linear absmax of sqrt(x)."""
    xb = _blocks(torch.sqrt(x.float()), block)
    s = xb.amax(dim=1) / 255.0
    q = torch.round(xb / torch.clamp(s, min=1e-30)[:, None]).clamp_(0, 255).to(torch.uint8)
    return q.reshape(-1)[:x.numel()].reshape(x.shape), s


def dequantize_v(q: torch.Tensor, s: torch.Tensor, block: int = BLOCK) -> torch.Tensor:
    r = _blocks(q, block) * s[:, None]
    return r.square().reshape(-1)[:q.numel()].reshape(q.shape)


def block_index(x: torch.Tensor, part: Part, block: int = BLOCK) -> torch.Tensor:
    """The block of each element of `x`, the rank's `part` of a whole
    tensor: its row-major index in the whole tensor // block (int64, x's
    shape)."""
    idx = torch.zeros(x.shape, dtype=torch.int64, device=x.device)
    stride = 1
    for d in reversed(range(x.ndim)):
        pos = torch.arange(x.shape[d], device=x.device) + (part.start if d == part.dim else 0)
        idx += (pos * stride).reshape([-1 if i == d else 1 for i in range(x.ndim)])
        stride *= part.shape[d]
    return idx // block


class AdamW8bit(ShardAware):
    """State per tensor: `qm` int8 and `qv` uint8 shaped like it, `sm` and
    `sv` fp32 [nblocks] (of the whole tensor): 2 bytes a parameter against
    AdamW's 8."""

    block = BLOCK
    PARAM_LIKE = ("qm", "qv")

    def __init__(self, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-4):
        self.b1, self.b2, self.eps, self.wd = b1, b2, eps, weight_decay

    def init(self, params: Mapping[str, torch.Tensor], groups=None
             ) -> Dict[str, Dict[str, torch.Tensor]]:
        nb = lambda k, p: _nblocks(math.prod(self.parts[k].shape) if k in self.parts
                                   else p.numel(), self.block)
        return {"qm": {k: torch.zeros_like(p, dtype=torch.int8) for k, p in params.items()},
                "qv": {k: torch.zeros_like(p, dtype=torch.uint8) for k, p in params.items()},
                "sm": {k: p.new_zeros(nb(k, p), dtype=torch.float32) for k, p in params.items()},
                "sv": {k: p.new_zeros(nb(k, p), dtype=torch.float32) for k, p in params.items()}}

    def _quantize(self, x: torch.Tensor, blk: torch.Tensor, nb: int, top: int, dtype):
        """`quantize_m` (top 127, x signed) or `quantize_v` (top 255, x =
        sqrt(v)) of a rank's part over the whole tensor's blocks `blk`."""
        s = x.new_zeros(nb).scatter_reduce_(0, blk.reshape(-1), x.abs().reshape(-1), "amax")
        s = self.all_max(s) / float(top)
        q = torch.round(x / torch.clamp(s, min=1e-30)[blk])
        return q.clamp_(-top if top == 127 else 0, top).to(dtype), s

    def _moments(self, k: str, state) -> Tuple[torch.Tensor, torch.Tensor, Optional[tuple]]:
        """(m, v) dequantized, and for a split tensor (its block index, the
        whole tensor's block count)."""
        qm, qv, sm, sv = (state[n][k] for n in ("qm", "qv", "sm", "sv"))
        part = self.parts.get(k)
        if part is None:
            return (dequantize_m(qm, sm, self.block), dequantize_v(qv, sv, self.block), None)
        blk = block_index(qm, part, self.block)
        return qm.float() * sm[blk], (qv.float() * sv[blk]).square(), (blk, sm.numel())

    def scaled(self, g: torch.Tensor, k: str, state, count: int) -> torch.Tensor:
        """JAX's `scale_by_adam8bit` for one tensor (`count` updates before
        this one): the Adam step, the state requantized in place."""
        b1, b2, blk = self.b1, self.b2, self.block
        t = torch.tensor(float(count + 1), dtype=torch.float32)
        bc1 = float(1.0 - torch.tensor(b1, dtype=torch.float32) ** t)
        bc2 = float(1.0 - torch.tensor(b2, dtype=torch.float32) ** t)
        g = g.float()
        m_old, v_old, split = self._moments(k, state)
        m = b1 * m_old + (1.0 - b1) * g
        v = b2 * v_old + (1.0 - b2) * g * g
        upd = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
        if split is None:
            codes = quantize_m(m, blk), quantize_v(v, blk)
        else:
            codes = (self._quantize(m, *split, 127, torch.int8),
                     self._quantize(torch.sqrt(v), *split, 255, torch.uint8))
        for (q_name, s_name), (q, s) in zip((("qm", "sm"), ("qv", "sv")), codes):
            state[q_name][k].copy_(q)
            state[s_name][k].copy_(s)
        return upd

    @torch.no_grad()
    def step(self, params: Mapping[str, torch.Tensor], grads: Mapping[str, torch.Tensor],
             state, groups: Mapping[str, List[str]], lrs: Mapping[str, float], count: int) -> None:
        for label, names in groups.items():
            for k in names:
                p = params[k]
                upd = self.scaled(grads[k], k, state, count)
                if self.wd:
                    upd = upd + self.wd * p.float()
                p.add_((-lrs[label] * upd).to(p.dtype))

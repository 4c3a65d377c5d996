"""Ring attention: sequence-parallel self-attention over a process group
(port of `bindyouravatar_tpu/ops/ring_attention.py`).

Each of the n ranks holds one shard of the joint sequence, flat
[B, S_local, H*D] q, k and v.  K/V blocks travel around the ring
(`batch_isend_irecv`, rank r sends to r + 1): the next block's exchange is
posted before the current block is computed, so the transfer overlaps the
compute.  Each (q shard, kv block) pair is one call of kernel B7's forward
(`flash_attention_flat_fwd`), which returns the block's output and the
per-row LSE; the blocks merge in fp32 by their LSEs.  JAX computes each
block with plain einsums, which at the DiT's full geometry would hold a
[B, H, S_local, S_local] fp32 score tensor per step.

Non-causal; `valid_len` masks the padded tail of the joint sequence.  A kv
block wholly past it is skipped (the kernel takes 0 < kv_len).  RoPE is
applied by the caller: in the ring q and k of one call come from
different shards, so the kernel's fused RoPE (same rows for both) does not
apply.  `ring_block` and `ring_merge` are the per-step pieces, so one
process can run every (rank, step) pair of a ring through the same code.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from .flash_attention import flash_attention_flat_fwd

Acc = Optional[Tuple[torch.Tensor, torch.Tensor]]


def block_kv_len(src: int, s_local: int, valid_len: Optional[int]) -> int:
    """The valid rows of kv block `src` (0 when it is all padding)."""
    if valid_len is None:
        return s_local
    return max(0, min(s_local, valid_len - src * s_local))


def ring_block(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int, src: int,
               scale: float, valid_len: Optional[int]):
    """One q shard against kv block `src`: (o [B, S, H*D], lse fp32
    [B, H, S]) of kernel B7's forward, or None for a block of padding only."""
    kv_len = block_kv_len(src, k.shape[1], valid_len)
    if kv_len == 0:
        return None
    return flash_attention_flat_fwd(q, k, v, heads, scale, kv_len)


def ring_merge(acc: Acc, blk) -> Acc:
    """Fold one block's (o, lse) into the fp32 accumulator (o_acc, lse_acc):
    lse = logaddexp(lse_acc, lse_blk), each output weighted by exp(its lse
    - lse)."""
    if blk is None:
        return acc
    o, lse = blk
    b, s, hd = o.shape
    heads = lse.shape[1]
    o = o.float().reshape(b, s, heads, hd // heads)
    if acc is None:
        return o, lse
    o_acc, lse_acc = acc
    lse_new = torch.logaddexp(lse_acc, lse)
    w = lambda l: torch.exp(l - lse_new).transpose(1, 2)[..., None]     # [B, S, H, 1]
    return o_acc * w(lse_acc) + o * w(lse), lse_new


def ring_finish(acc: Acc, dtype: torch.dtype) -> torch.Tensor:
    o, _ = acc
    return o.reshape(o.shape[0], o.shape[1], -1).to(dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                   group: Optional[dist.ProcessGroup] = None, scale: Optional[float] = None,
                   valid_len: Optional[int] = None) -> torch.Tensor:
    """q/k/v: this rank's shard [B, S_local, H*D] of a sequence sharded in
    rank order over `group` (every shard the same length; `valid_len` the
    global count of real rows).  Returns this rank's rows of the attention
    output [B, S_local, H*D] in q's dtype."""
    n = dist.get_world_size(group) if group is not None else 1
    me = dist.get_rank(group) if group is not None else 0
    if scale is None:
        scale = (q.shape[-1] // heads) ** -0.5
    nxt = dist.get_global_rank(group, (me + 1) % n) if n > 1 else 0
    prv = dist.get_global_rank(group, (me - 1) % n) if n > 1 else 0
    acc: Acc = None
    kb, vb = k.contiguous(), v.contiguous()
    for i in range(n):
        reqs = []
        if i < n - 1:
            k_in, v_in = torch.empty_like(kb), torch.empty_like(vb)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, kb, nxt, group), dist.P2POp(dist.isend, vb, nxt, group),
                dist.P2POp(dist.irecv, k_in, prv, group), dist.P2POp(dist.irecv, v_in, prv, group)])
        acc = ring_merge(acc, ring_block(q, kb, vb, heads, (me - i) % n, scale, valid_len))
        if reqs:
            for r in reqs:
                r.wait()
            kb, vb = k_in, v_in
    return ring_finish(acc, q.dtype)


def ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int, n: int,
                         scale: Optional[float] = None, valid_len: Optional[int] = None
                         ) -> torch.Tensor:
    """Every rank's ring of an n-rank `ring_attention` in one process: the
    global q/k/v [B, S, H*D] (S a multiple of n) cut into n shards, each
    shard's n steps through `ring_block` and `ring_merge` in the ring's
    order; the output rows concatenated [B, S, H*D]."""
    if scale is None:
        scale = (q.shape[-1] // heads) ** -0.5
    qs, ks, vs = ([c.contiguous() for c in t.chunk(n, dim=1)] for t in (q, k, v))
    out = []
    for me in range(n):
        acc: Acc = None
        for i in range(n):
            src = (me - i) % n
            acc = ring_merge(acc, ring_block(qs[me], ks[src], vs[src], heads, src, scale,
                                             valid_len))
        out.append(ring_finish(acc, q.dtype))
    return torch.cat(out, dim=1)

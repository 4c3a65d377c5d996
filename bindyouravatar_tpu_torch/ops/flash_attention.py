"""Flash attention: the flat kernels B1 (inference forward with fused QK-LN
and RoPE) and B7 (the differentiable training attention: forward saving
the LSE, and the dq/dk/dv backward), and the general-layout kernels B11
(forward over [B, H, S, D] or [B, S, H, D]) and B12 + B13 (its dq/dk/dv
backward).

The forwards come from `csrc/flash_attention.cu` (one body templated on
the head dim and the scale mode), the backwards from
`csrc/flash_attention_bwd.cu`: one fused wgmma + TMA kernel that computes
dq, dk and dv in one pass over the tiles, beside a pre-pass and a dq
post-pass, instantiated for B7 (flat, the scale folded into the prepared
q, delta given) and for B12 + B13 (the scale on the scores, delta
computed).  The flat kernels replace the TPU kernels `_fwd_flat_t_kernel`
(B1), `_fwd_flat_kernel` and `_bwd_flat_kernel` (B7, the `_flash_flat`
custom vjp) of `bindyouravatar_tpu/ops/flash_attention.py`; B11 replaces
`_fwd_kernel` and the fused backward `_dkv_kernel` and `_dq_kernel` (the
`_flash` custom vjp and the fused QK-LN inference form of
`flash_attention(layout="bhsd" | "bshd")`); the source notes say what
bounds them on the H100 and how they are built.  Unlike the TPU path, V
arrives in the caller's own layout, the output and the gradients leave in
it, and the sequence is not padded: the kernels mask the ragged tail
themselves.  The port does not mirror the JAX switch `COMBINED_BWD`, which
picks between the combined and the two-kernel TPU backward for VMEM and
layout reasons: on the GPU every backward is the one fused kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ._build import check, cuda_lib
from .rope import apply_rotary_emb

QK_NORM_EPS = 1e-6


def _head_layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    c = x32 - mean
    var = (c * c).mean(-1, keepdim=True)
    return (c * torch.rsqrt(var + QK_NORM_EPS) * scale.float() + bias.float()).to(x.dtype)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                          scale: Optional[float] = None, kv_len: Optional[int] = None,
                          rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                          rope_start: int = 0,
                          qk_norm: Optional[Tuple[torch.Tensor, ...]] = None,
                          block_q: int = 1024) -> torch.Tensor:
    """Plain version of B1 (the JAX package's XLA fallback math): per-head
    LN -> dtype, RoPE -> dtype, fp32-softmax attention, flat out; B11's
    plain version on the [B, S, H, D] view."""
    b, s, hd = q.shape
    view = lambda t: t.reshape(b, s, heads, hd // heads)
    o, _ = flash_attention_fwd_plain(view(q), view(k), view(v), "bshd", scale, kv_len, rope,
                                     rope_start, qk_norm, block_q)
    return o.reshape(b, s, hd)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    heads: Optional[int] = None, scale: Optional[float] = None,
                    kv_len: Optional[int] = None,
                    rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    rope_start: int = 0,
                    qk_norm: Optional[Tuple[torch.Tensor, ...]] = None,
                    layout: Optional[str] = None) -> torch.Tensor:
    """Non-causal self-attention (the JAX `flash_attention`).

    `layout="flat"` (the default when `heads` is given): q/k/v [B, S, H*D]
    -> [B, S, H*D] through kernel B1, inference only.  `layout="bhsd"`
    (the default otherwise, as in JAX) or `"bshd"`: q/k/v [B, H, S, D] or
    [B, S, H, D], output in the same layout, through `flash_attention_layout`
    (B11, and the fused B12 + B13 for its gradient).

    `qk_norm=(q_scale, q_bias, k_scale, k_bias)` ([D] each) applies the
    per-head LayerNorm (eps 1e-6, fp32 stats); `rope=(cos, sin)` ([R, D])
    rotates rows [rope_start, rope_start + R) after it; kv rows >= kv_len
    are masked.  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel (bf16; flat: D = 64) or raises."""
    if layout is None:
        layout = "flat" if heads is not None else "bhsd"
    if layout != "flat":
        return flash_attention_layout(q, k, v, layout, scale, kv_len, rope, rope_start, qk_norm)
    _require(heads is not None, "layout='flat' requires heads")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, heads, scale, kv_len, rope, rope_start, qk_norm)
    b, s, hd = q.shape
    d = hd // heads
    if scale is None:
        scale = d ** -0.5
    if kv_len is None:
        kv_len = s
    _check_flat(q, k, v, heads, kv_len)
    dev = q.device
    f32 = lambda t: t.to(device=dev, dtype=torch.float32).contiguous()
    ln = [None] * 4 if qk_norm is None else [f32(a) for a in qk_norm]
    cos, sin, rope_rows = _rope_tables(rope, rope_start, s, d, dev)
    o = torch.empty_like(q)
    q_prep, k_prep = torch.empty_like(q), torch.empty_like(k)
    ptr = lambda t: None if t is None else t.data_ptr()
    err = cuda_lib().bya_flash_attention_flat(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), q_prep.data_ptr(),
        k_prep.data_ptr(), *[ptr(a) for a in ln], ptr(cos), ptr(sin), rope_start,
        rope_rows, b, s, heads, kv_len, float(scale), QK_NORM_EPS, None,
        torch.cuda.current_stream(dev).cuda_stream)
    check(err, "flash_attention (B1)")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise ValueError(f"flash_attention kernel: {what}")


def _rope_tables(rope, rope_start: int, s: int, d: int, dev: torch.device):
    """(cos, sin, rope_rows) as contiguous fp32 on `dev`, or (None, None, 0)."""
    if rope is None:
        return None, None, 0
    cos, sin = (t.to(device=dev, dtype=torch.float32).contiguous() for t in rope)
    rows = cos.shape[0]
    _require(cos.shape == (rows, d) and sin.shape == cos.shape and rope_start + rows <= s,
             "rope tables do not fit the sequence")
    return cos, sin, rows


def _check_flat(q, k, v, heads: int, kv_len: int) -> None:
    b, s, hd = q.shape
    d = hd // heads
    _require(q.device.type == "cuda", f"tensors on {q.device}")
    _require(d == 64 and hd == heads * d, f"head dim {hd}/{heads}, kernel takes 64")
    _require(k.shape == q.shape and v.shape == q.shape, "q, k, v shapes differ")
    _require(0 < kv_len <= s, f"kv_len {kv_len} outside (0, {s}]")
    for t in (q, k, v):
        _require(t.dtype == torch.bfloat16 and t.is_contiguous()
                 and t.data_ptr() % 16 == 0, "q, k, v must be contiguous 16-byte aligned bf16")


def _rope(x: torch.Tensor, rope, rope_start: int, sign: float = 1.0) -> torch.Tensor:
    """Rotate rows [rope_start, rope_start + R) of [..., S, D] x (`sign=-1`:
    the adjoint rotation, sin negated); other rows unchanged."""
    if rope is None:
        return x
    cos, sin = rope
    end = rope_start + cos.shape[0]
    return torch.cat([x[..., :rope_start, :],
                      apply_rotary_emb(x[..., rope_start:end, :], cos, sign * sin),
                      x[..., end:, :]], dim=-2)


def _rope_qk(q: torch.Tensor, k: torch.Tensor, rope, rope_start: int, sign: float = 1.0):
    return _rope(q, rope, rope_start, sign), _rope(k, rope, rope_start, sign)


def flash_attention_flat_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                   heads: int, scale: Optional[float] = None,
                                   kv_len: Optional[int] = None,
                                   rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                                   rope_start: int = 0, block_q: int = 1024):
    """Plain version of B7's forward: RoPE -> dtype, fp32-softmax attention
    (p rounded to v's dtype for the PV product), flat out, and the per-row
    natural LSE of the scaled scores, fp32 [B, H, S]; B11's plain version
    on the [B, S, H, D] view."""
    b, s, hd = q.shape
    view = lambda t: t.reshape(b, s, heads, hd // heads)
    o, lse = flash_attention_fwd_plain(view(q), view(k), view(v), "bshd", scale, kv_len, rope,
                                       rope_start, None, block_q)
    return o.reshape(b, s, hd), lse


def flash_attention_flat_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                   do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                                   heads: int, scale: Optional[float] = None,
                                   kv_len: Optional[int] = None,
                                   rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                                   rope_start: int = 0, block_q: int = 1024):
    """Plain version of B7's backward: the explicit flash-backward math from
    (q, k, v, dO, lse, delta = rowsum(o * dO)) -- P = exp(s - lse) with the
    masked kv rows exactly 0, dV = P^T dO, dS = P (dO V^T - delta) rounded to
    q's dtype, dq = dS k scale, dk = dS^T q scale on the rotated q and k --
    then the RoPE adjoint (cos, -sin) on dq and dk.  Flat [B, S, H*D] out."""
    b, s, hd = q.shape
    d = hd // heads
    scale = d ** -0.5 if scale is None else scale
    split = lambda x: x.reshape(b, s, heads, d).transpose(1, 2)
    merge = lambda x: x.transpose(1, 2).reshape(b, s, hd).to(q.dtype)
    qh, kh = _rope_qk(split(q), split(k), rope, rope_start)
    vh, doh = split(v).float(), split(do).float()
    kf = kh.float()
    valid = torch.arange(s, device=q.device) < (s if kv_len is None else kv_len)
    dq_parts = []
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vh)
    for i in range(0, s, block_q):
        sl = slice(i, i + block_q)
        qb = qh[..., sl, :].float()
        p = torch.exp(torch.matmul(qb, kf.transpose(-1, -2)) * scale - lse[..., sl, None])
        p = p.masked_fill(~valid, 0.0)
        dv += torch.matmul(p.to(q.dtype).float().transpose(-1, -2), doh[..., sl, :])
        dp = torch.matmul(doh[..., sl, :], vh.transpose(-1, -2))
        ds = (p * (dp - delta[..., sl, None])).to(q.dtype).float()
        dq_parts.append(torch.matmul(ds, kf) * scale)
        dk += torch.matmul(ds.transpose(-1, -2), qb) * scale
    dq, dk = _rope_qk(torch.cat(dq_parts, dim=-2), dk, rope, rope_start, sign=-1.0)
    return merge(dq), merge(dk), merge(dv)


def flash_attention_flat_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                             scale: Optional[float] = None, kv_len: Optional[int] = None,
                             rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                             rope_start: int = 0):
    """Kernel B7's forward on its own: (o [B, S, H*D], lse fp32 [B, H, S]).
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (bf16, D = 64) or raises."""
    if q.device.type == "cpu":
        return flash_attention_flat_fwd_plain(q, k, v, heads, scale, kv_len, rope, rope_start)
    b, s, hd = q.shape
    d = hd // heads
    scale = d ** -0.5 if scale is None else scale
    kv_len = s if kv_len is None else kv_len
    _check_flat(q, k, v, heads, kv_len)
    cos, sin, rope_rows = _rope_tables(rope, rope_start, s, d, q.device)
    o = torch.empty_like(q)
    lse = torch.empty((b, heads, s), dtype=torch.float32, device=q.device)
    q_prep, k_prep = torch.empty_like(q), torch.empty_like(k)
    ptr = lambda t: None if t is None else t.data_ptr()
    err = cuda_lib().bya_flash_attention_flat(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), q_prep.data_ptr(),
        k_prep.data_ptr(), None, None, None, None, ptr(cos), ptr(sin), rope_start, rope_rows,
        b, s, heads, kv_len, float(scale), 0.0, lse.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "flash_attention_flat forward (B7)")
    flash_attention_flat_fwd.launches += 1
    return o, lse


def flash_attention_flat_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                             heads: int, scale: Optional[float] = None,
                             kv_len: Optional[int] = None,
                             rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                             rope_start: int = 0):
    """Kernel B7's backward on its own: (dq, dk, dv), each [B, S, H*D] in
    q's dtype.  A CPU tensor takes the plain version; a CUDA tensor launches
    the fused kernel (bf16, D = 64) or raises."""
    if q.device.type == "cpu":
        return flash_attention_flat_bwd_plain(q, k, v, do, lse, delta, heads, scale, kv_len,
                                              rope, rope_start)
    b, s, hd = q.shape
    d = hd // heads
    scale = d ** -0.5 if scale is None else scale
    kv_len = s if kv_len is None else kv_len
    _check_flat(q, k, v, heads, kv_len)
    do = do.to(q.dtype).contiguous()
    _require(do.shape == q.shape and lse.shape == (b, heads, s) and delta.shape == lse.shape,
             "dO, lse or delta shape")
    lse, delta = lse.float().contiguous(), delta.float().contiguous()
    cos, sin, rope_rows = _rope_tables(rope, rope_start, s, d, q.device)
    grads = _fused_bwd(True, q, k, v, None, do, lse, delta, (b, s, heads, d), True, kv_len,
                       scale, cos, sin, rope_start, rope_rows, "flash_attention_flat backward (B7)")
    flash_attention_flat_bwd.launches += 1
    return grads


def _fused_bwd(flat: bool, q, k, v, o, do, lse, delta, dims, bshd: bool, kv_len: int,
               scale: float, cos, sin, rope_start: int, rope_rows: int, what: str):
    """Launch the fused backward (`csrc/flash_attention_bwd.cu`: pre-pass,
    the dq/dk/dv kernel, dq post-pass) on checked CUDA tensors; returns (dq,
    dk, dv).  The wrapper allocates the workspaces: the prepared q and k
    (B7's q scale, RoPE), lse2 and delta per row, the fp32 dq accumulator."""
    b, s, h, d = dims
    s_pad = -(-s // 64) * 64
    dev = q.device
    prep = flat or cos is not None
    q_prep, k_prep = (torch.empty_like(q), torch.empty_like(k)) if prep else (None, None)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dq_acc = torch.empty(b * h * s_pad * d, dtype=torch.float32, device=dev)
    lse2, delta_ws = (torch.empty(b * h * s_pad, dtype=torch.float32, device=dev)
                      for _ in range(2))
    ptr = lambda t: None if t is None else t.data_ptr()
    err = cuda_lib().bya_flash_bwd(
        int(flat), q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(o), do.data_ptr(),
        lse.data_ptr(), ptr(delta), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), ptr(q_prep),
        ptr(k_prep), dq_acc.data_ptr(), lse2.data_ptr(), delta_ws.data_ptr(), ptr(cos), ptr(sin),
        rope_start, rope_rows, b, s, h, d, int(bshd), kv_len, float(scale),
        torch.cuda.current_stream(dev).cuda_stream)
    check(err, what)
    return dq, dk, dv


flash_attention_flat_fwd.launches = 0
flash_attention_flat_bwd.launches = 0


def attention_delta(o: torch.Tensor, do: torch.Tensor, heads: int) -> torch.Tensor:
    """delta = rowsum(o * dO) per head, fp32 [B, H, S] (the JAX package
    computes it in XLA, outside the backward kernel)."""
    b, s, hd = o.shape
    return (o.float() * do.float()).reshape(b, s, heads, hd // heads).sum(-1).transpose(1, 2)


class _FlashFlat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, heads, scale, kv_len, rope, rope_start):
        o, lse = flash_attention_flat_fwd(q, k, v, heads, scale, kv_len, rope, rope_start)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (heads, scale, kv_len, rope, rope_start)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        heads = ctx.args[0]
        dq, dk, dv = flash_attention_flat_bwd(q, k, v, do, lse, attention_delta(o, do, heads),
                                              *ctx.args)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_flat(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                         scale: Optional[float] = None, kv_len: Optional[int] = None,
                         rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                         rope_start: int = 0) -> torch.Tensor:
    """Differentiable non-causal attention over flat q/k/v [B, S, H*D] ->
    [B, S, H*D] with optional rotate-half RoPE on rows [rope_start,
    rope_start + R) and kv rows >= kv_len masked (no QK LayerNorm: the
    training path applies it outside, as the JAX `_flash_flat` does).  A
    CPU tensor takes the plain version (autograd differentiates it); a CUDA
    tensor launches kernel B7's forward, and its backward B7's backward."""
    if q.device.type == "cpu":
        return flash_attention_flat_fwd_plain(q, k, v, heads, scale, kv_len, rope,
                                              rope_start)[0]
    return _FlashFlat.apply(q.contiguous(), k.contiguous(), v.contiguous(), heads, scale,
                            kv_len, rope, rope_start)


# ------------------------------------------------ bhsd / bshd: B11, B12 + B13

LAYOUTS = ("bhsd", "bshd")


def _heads_major(x: torch.Tensor, layout: str) -> torch.Tensor:
    """[B, H, S, D] view of a `layout` tensor (and back: the swap is its own
    inverse)."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout {layout!r}: expected one of {LAYOUTS} or 'flat'")
    return x if layout == "bhsd" else x.transpose(1, 2)


def flash_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              layout: str = "bhsd", scale: Optional[float] = None,
                              kv_len: Optional[int] = None,
                              rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                              rope_start: int = 0,
                              qk_norm: Optional[Tuple[torch.Tensor, ...]] = None,
                              block_q: int = 1024):
    """Plain version of B11 (the JAX package's XLA fallback math): per-head
    LN -> dtype, RoPE -> dtype, fp32 scores * scale with kv rows >= kv_len
    masked, fp32 softmax with p rounded to v's dtype for the PV product.
    Returns (o in `layout`, the per-row natural LSE, fp32 [B, H, S])."""
    qh, kh, vh = (_heads_major(t, layout) for t in (q, k, v))
    s, d = qh.shape[-2:]
    scale = d ** -0.5 if scale is None else scale
    if qk_norm is not None:
        qs, qb, ks, kb = qk_norm
        qh, kh = _head_layernorm(qh, qs, qb), _head_layernorm(kh, ks, kb)
    qh, kh = _rope_qk(qh, kh, rope, rope_start)
    kf = kh.float().transpose(-1, -2)
    valid = torch.arange(s, device=q.device) < (s if kv_len is None else kv_len)
    outs, lses = [], []
    for i in range(0, s, block_q):
        sc = torch.matmul(qh[..., i:i + block_q, :].float(), kf) * scale
        sc = sc.masked_fill(~valid, float("-inf"))
        lse = torch.logsumexp(sc, dim=-1)
        outs.append(torch.matmul(torch.exp(sc - lse[..., None]).to(v.dtype), vh))
        lses.append(lse)
    return _heads_major(torch.cat(outs, dim=-2), layout), torch.cat(lses, dim=-1)


def _bwd_plain(q, k, v, o, do, lse, layout, scale, kv_len, rope, rope_start, block_q,
               want_dq: bool):
    """The math of `_dkv_kernel` (want_dq=False: (dk, dv)) and `_dq_kernel`
    (dq): P = exp(s * scale - lse) with the masked kv columns exactly 0,
    delta = rowsum(o * dO), dS = P (dO V^T - delta) * scale rounded to q's
    dtype, dV = P^T dO with P rounded to dO's dtype, dK = dS^T q, dQ = dS k
    on the rotated q and k, then the RoPE adjoint (cos, -sin)."""
    qh, kh, vh, oh, doh = (_heads_major(t, layout) for t in (q, k, v, o, do))
    s, d = qh.shape[-2:]
    scale = d ** -0.5 if scale is None else scale
    qh, kh = _rope_qk(qh, kh, rope, rope_start)
    kf, vf, dof = kh.float(), vh.float(), doh.float()
    delta = (oh.float() * dof).sum(-1)
    valid = torch.arange(s, device=q.device) < (s if kv_len is None else kv_len)
    dq_parts, dk, dv = [], torch.zeros_like(kf), torch.zeros_like(vf)
    for i in range(0, s, block_q):
        sl = slice(i, i + block_q)
        qb = qh[..., sl, :].float()
        p = torch.exp(torch.matmul(qb, kf.transpose(-1, -2)) * scale - lse[..., sl, None])
        p = p.masked_fill(~valid, 0.0)
        dp = torch.matmul(dof[..., sl, :], vf.transpose(-1, -2))
        ds = (p * (dp - delta[..., sl, None]) * scale).to(q.dtype).float()
        if want_dq:
            dq_parts.append(torch.matmul(ds, kf))
        else:
            dv += torch.matmul(p.to(do.dtype).float().transpose(-1, -2), dof[..., sl, :])
            dk += torch.matmul(ds.transpose(-1, -2), qb)
    out = lambda g: _heads_major(g, layout).to(q.dtype)
    if want_dq:
        return out(_rope(torch.cat(dq_parts, dim=-2), rope, rope_start, sign=-1.0))
    return out(_rope(dk, rope, rope_start, sign=-1.0)), out(dv)


def flash_attention_dkv_plain(q, k, v, o, do, lse, layout: str = "bhsd",
                              scale: Optional[float] = None, kv_len: Optional[int] = None,
                              rope=None, rope_start: int = 0, block_q: int = 1024):
    """Plain version of the B12 half, (dk, dv) in `layout` (see `_bwd_plain`)."""
    return _bwd_plain(q, k, v, o, do, lse, layout, scale, kv_len, rope, rope_start, block_q,
                      want_dq=False)


def flash_attention_dq_plain(q, k, v, o, do, lse, layout: str = "bhsd",
                             scale: Optional[float] = None, kv_len: Optional[int] = None,
                             rope=None, rope_start: int = 0, block_q: int = 1024):
    """Plain version of the B13 half, dq in `layout` (see `_bwd_plain`)."""
    return _bwd_plain(q, k, v, o, do, lse, layout, scale, kv_len, rope, rope_start, block_q,
                      want_dq=True)


def _layout_dims(q: torch.Tensor, layout: str):
    """(B, S, H, D) of a `layout` tensor."""
    b, h, s, d = _heads_major(q, layout).shape
    return b, s, h, d


def _check_layout(layout: str, *tensors) -> None:
    """The general-layout kernels' contract: CUDA bf16 tensors of one shape,
    contiguous in their layout, D = 64 or 128.  Rows are read as 16-byte
    vectors, bhsd rows D apart and bshd rows H*D apart, which needs D % 8
    == 0 and 16-byte aligned tensors."""
    q = tensors[0]
    d = q.shape[-1]
    _require(q.device.type == "cuda", f"tensors on {q.device}")
    _require(d in (64, 128), f"head dim {d}: the {layout} kernels take 64 or 128")
    for t in tensors:
        _require(t.shape == q.shape, f"shapes {tuple(t.shape)} and {tuple(q.shape)} differ")
        _require(t.dtype == torch.bfloat16 and t.is_contiguous() and t.data_ptr() % 16 == 0,
                 "tensors must be contiguous 16-byte aligned bf16")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        layout: str = "bhsd", scale: Optional[float] = None,
                        kv_len: Optional[int] = None,
                        rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                        rope_start: int = 0,
                        qk_norm: Optional[Tuple[torch.Tensor, ...]] = None):
    """Kernel B11: (o in `layout`, lse fp32 [B, H, S]) over q/k/v [B, H, S, D]
    (`layout="bhsd"`) or [B, S, H, D] (`"bshd"`), with the options of
    `flash_attention`.  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel (bf16, D = 64 or 128) or raises."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, layout, scale, kv_len, rope, rope_start,
                                         qk_norm)
    b, s, h, d = _layout_dims(q, layout)
    scale = d ** -0.5 if scale is None else scale
    kv_len = s if kv_len is None else kv_len
    _check_layout(layout, q, k, v)
    _require(0 < kv_len <= s, f"kv_len {kv_len} outside (0, {s}]")
    f32 = lambda t: t.to(device=q.device, dtype=torch.float32).contiguous()
    ln = [None] * 4 if qk_norm is None else [f32(a) for a in qk_norm]
    _require(all(a is None or a.shape == (d,) for a in ln), "qk_norm affines must be [D]")
    cos, sin, rope_rows = _rope_tables(rope, rope_start, s, d, q.device)
    prep = qk_norm is not None or rope is not None
    q_prep, k_prep = (torch.empty_like(q), torch.empty_like(k)) if prep else (None, None)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    err = cuda_lib().bya_flash_layout_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), ptr(q_prep), ptr(k_prep),
        *[ptr(a) for a in ln], ptr(cos), ptr(sin), rope_start, rope_rows, b, s, h, d,
        int(layout == "bshd"), kv_len, float(scale), QK_NORM_EPS, lse.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "flash_attention_fwd (B11)")
    flash_attention_fwd.launches += 1
    return o, lse


def flash_attention_bwd_plain(q, k, v, o, do, lse, layout: str = "bhsd",
                              scale: Optional[float] = None, kv_len: Optional[int] = None,
                              rope=None, rope_start: int = 0, block_q: int = 1024):
    """Plain version of the fused B12 + B13 backward: (dq, dk, dv) in
    `layout`, composed of `flash_attention_dq_plain` and
    `flash_attention_dkv_plain` (see `_bwd_plain`)."""
    dq = flash_attention_dq_plain(q, k, v, o, do, lse, layout, scale, kv_len, rope, rope_start,
                                  block_q)
    return (dq, *flash_attention_dkv_plain(q, k, v, o, do, lse, layout, scale, kv_len, rope,
                                           rope_start, block_q))


def flash_attention_bwd(q, k, v, o, do, lse, layout: str = "bhsd",
                        scale: Optional[float] = None, kv_len: Optional[int] = None,
                        rope=None, rope_start: int = 0):
    """The B12 + B13 backward: (dq, dk, dv) in `layout` from q, k, v, the
    forward's o and LSE and dO (delta = rowsum(o * dO) is computed in the
    pre-pass), one fused launch (`csrc/flash_attention_bwd.cu`).  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel or
    raises."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, do, lse, layout, scale, kv_len, rope,
                                         rope_start)
    b, s, h, d = _layout_dims(q, layout)
    scale = d ** -0.5 if scale is None else scale
    kv_len = s if kv_len is None else kv_len
    do = do.to(q.dtype).contiguous()
    _check_layout(layout, q, k, v, o, do)
    _require(0 < kv_len <= s, f"kv_len {kv_len} outside (0, {s}]")
    _require(lse.shape == (b, h, s) and lse.dtype == torch.float32 and lse.is_contiguous(),
             "lse must be contiguous fp32 [B, H, S]")
    cos, sin, rope_rows = _rope_tables(rope, rope_start, s, d, q.device)
    grads = _fused_bwd(False, q, k, v, o, do, lse, None, (b, s, h, d), layout == "bshd", kv_len,
                       scale, cos, sin, rope_start, rope_rows, "flash_attention backward (B12+B13)")
    flash_attention_bwd.launches += 1
    return grads


flash_attention_fwd.launches = 0
flash_attention_bwd.launches = 0


class _FlashLayout(torch.autograd.Function):
    """The JAX `_flash` custom vjp: B11 forward saving the LSE, the fused
    B12 + B13 backward."""

    @staticmethod
    def forward(ctx, q, k, v, layout, scale, kv_len, rope, rope_start):
        o, lse = flash_attention_fwd(q, k, v, layout, scale, kv_len, rope, rope_start)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (layout, scale, kv_len, rope, rope_start)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do, lse, *ctx.args)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_layout(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           layout: str = "bhsd", scale: Optional[float] = None,
                           kv_len: Optional[int] = None,
                           rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                           rope_start: int = 0,
                           qk_norm: Optional[Tuple[torch.Tensor, ...]] = None) -> torch.Tensor:
    """Non-causal self-attention over q/k/v [B, H, S, D] (`layout="bhsd"`)
    or [B, S, H, D] (`"bshd"`), output in the same layout (the bhsd/bshd
    branch of the JAX `flash_attention`).  With `qk_norm` the call is
    inference only (B11 with the LN fused; no backward), as in JAX.
    Without, it is differentiable: B11 forward, the fused B12 + B13 backward.  A
    CPU tensor takes the plain version (autograd differentiates it)."""
    if qk_norm is not None:
        return flash_attention_fwd(q, k, v, layout, scale, kv_len, rope, rope_start, qk_norm)[0]
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, layout, scale, kv_len, rope, rope_start)[0]
    return _FlashLayout.apply(q.contiguous(), k.contiguous(), v.contiguous(), layout, scale,
                              kv_len, rope, rope_start)

"""Long-query / short-KV cross-attention: kernels B2, B3, B14, B2c and B2h.

The kernels replace TPU kernels of `bindyouravatar_tpu/ops/short_kv_attention.py`;
all five are instantiations of one templated body in
`csrc/short_kv_attention.cu`, whose source note says what bounds them on
the H100.
  * B3 (`_kernel_flat`), with the identity combine: the audio
    cross-attention calls it once per layer; every latent frame's 1,350
    video queries attend to that frame's audio tokens of each identity
    (`AudioConfig.context_tokens`, 32 at the 5B), and the per-identity
    results are summed with the routing weights.
  * B2 (`_kernel`, `combine=False`): the perceiver face injection calls it
    once per face layer, on the flat projection (`short_kv_attention_flat`);
    all 17,550 video queries attend to each identity's face tokens
    (`DiTConfig.lfe_num_tokens`, 32 at the 5B), one output per identity,
    combined later by the caller.
  * B2h: the same body in JAX's head-major layout, behind the JAX-layout
    entry `short_kv_attention` (q [G, H, Sq, D]).
  * B14 (`_kernel_qmajor`, both modes): `short_kv_attention_qmajor` and
    `short_kv_attention_combined_qmajor`, q in the projections' q-major
    [G, Sq, H, D] layout.
  * B2c (`_kernel`, `combine=True`): `short_kv_attention_combined`,
    head-major q [G, H, Sq, D], weighted sum over the identities.
Every kernel takes heads of any D % 8 == 0 up to 256, at any head count, on
the narrowest of three bodies (64, 128, 256 columns: `short_kv_body` is the
rule; past it a CUDA call raises, naming its ROADMAP.md queue B item), and
any K >= 1 tokens an identity and I >= 1 identities: K = 32 with I <= 4,
the shipped configuration, on the shipped body, every other K and I on the
general body (a `wgmma` body over every identity's keys in 64-column key
blocks of 16, 32 or 64 keys an identity; keys past 64 in chunks, the
softmax in two passes), combined attention on the 16-key block on the
earlier warp body, which measured faster there (the source note says how).  The combined mode's
weight slices share a block's shared memory, which bounds I at a few
hundred identities.  JAX's `_kernel_flat` asserts that its heads fill 128
lanes in pairs (47 x 64 or 189 x 16 do not); the port's B3 takes any head
count.
The entry points with JAX's names take JAX's layouts.  Their gradients take
the vjp of the plain versions, recomputed from the saved inputs (the
routing weights `w` included), as the JAX custom vjps `_bwd_a`, `_bwd_c`,
`_bwd_aq`, `_bwd_cq` and `_bwd_cf` do: the JAX package has no Pallas
backward here.
"""

from __future__ import annotations

from typing import Optional

import torch

from ._build import check, cuda_lib
from .autograd import kernel_with_plain_vjp
from .flash_attention import body_width

def short_kv_body(d: int) -> int:
    """The columns of the body a D-wide head runs on: 64 for D <= 64, 128 up
    to 128, 256 up to 256, as the flash kernels' (the tensor maps read the
    columns past D as zeros).  Raises ValueError naming ROADMAP.md queue B
    item 3 for D % 8 != 0 and item 4 for D > 256 (`body_width`)."""
    return body_width(d, "short-KV kernels")


def short_kv_attention_combined_flat_plain(q: torch.Tensor, k: torch.Tensor,
                                           v: torch.Tensor, w: torch.Tensor,
                                           sm_scale: float) -> torch.Tensor:
    """Plain version of B3 (the JAX `_spec_combined_flat`)."""
    g, sq, hd = q.shape
    h, d = k.shape[2], k.shape[4]
    return short_kv_attention_combined_qmajor_plain(q.reshape(g, sq, h, d), k, v, w,
                                                    sm_scale).reshape(g, sq, hd)


def short_kv_attention_combined_flat(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                     w: torch.Tensor, sm_scale: float) -> torch.Tensor:
    """q [G, Sq, H*D], k/v [G, I, H, K, D], w [G, Sq, I] ->
    sum_i w_i * softmax(q k_i^T * sm_scale) v_i as [G, Sq, H*D].  A CPU
    tensor takes the plain version; a CUDA tensor launches kernel B3
    (bf16, D % 8 == 0 up to 256, any head count, any K and I) or raises."""
    if q.device.type == "cpu":
        return short_kv_attention_combined_flat_plain(q, k, v, w, sm_scale)
    return kernel_with_plain_vjp(_combined_flat_kernel, short_kv_attention_combined_flat_plain,
                                 (q, k, v, w), (sm_scale,))


def _combined_flat_kernel(q, k, v, w, sm_scale: float) -> torch.Tensor:
    g, sq, hd = q.shape
    n_id, h, kk, d = k.shape[1], k.shape[2], k.shape[3], k.shape[4]
    short_kv_body(d)
    ok = (q.device.type == "cuda" and hd == h * d and k.shape == (g, n_id, h, kk, d)
          and v.shape == k.shape and w.shape == (g, sq, n_id) and _kernel_dtype_ok(q, k, v, w))
    if not ok:
        raise ValueError(
            f"short_kv_attention kernel takes contiguous bf16 CUDA q [G,Sq,H*D], "
            f"k/v [G,I,H,K,D], w [G,Sq,I]; got "
            f"q {tuple(q.shape)} {q.dtype}, k {tuple(k.shape)}, w {tuple(w.shape)} "
            f"on {q.device}")
    o = torch.empty_like(q)
    err = cuda_lib().bya_short_kv_attention_combined_flat(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), o.data_ptr(),
        g, sq, n_id, h, kk, d, float(sm_scale), torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "short_kv_attention_combined_flat (B3)")
    short_kv_attention_combined_flat.launches += 1
    return o


short_kv_attention_combined_flat.launches = 0


def _kernel_dtype_ok(*tensors) -> bool:
    return all(t.dtype == torch.bfloat16 and t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in tensors)


def short_kv_attention_flat_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  sm_scale: float) -> torch.Tensor:
    """Plain version of B2 (the JAX `_spec_attend`, with flat q and output)."""
    b, sq, hd = q.shape
    n_id, h, d = k.shape[1], k.shape[2], k.shape[4]
    o = short_kv_attention_qmajor_plain(q.reshape(b, sq, h, d), k, v, sm_scale)
    return o.reshape(b, n_id, sq, hd)


def short_kv_attention_flat(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            sm_scale: float) -> torch.Tensor:
    """q [B, Sq, H*D], k/v [B, I, H, K, D] -> softmax(q k_i^T * sm_scale) v_i
    per identity as [B, I, Sq, H*D].  A CPU tensor takes the plain version;
    a CUDA tensor launches kernel B2 (bf16, any K and I, D % 8 == 0 up to
    256, on the body `short_kv_body` names, whose columns past D the
    kernel's loads fill with zeros) or raises."""
    if q.device.type == "cpu":
        return short_kv_attention_flat_plain(q, k, v, sm_scale)
    return kernel_with_plain_vjp(_flat_kernel, short_kv_attention_flat_plain, (q, k, v),
                                 (sm_scale,))


def _flat_kernel(q, k, v, sm_scale: float) -> torch.Tensor:
    b, sq, hd = q.shape
    n_id, h, kk, d = k.shape[1], k.shape[2], k.shape[3], k.shape[4]
    short_kv_body(d)
    ok = (q.device.type == "cuda" and hd == h * d and k.shape == (b, n_id, h, kk, d)
          and v.shape == k.shape and _kernel_dtype_ok(q, k, v))
    if not ok:
        raise ValueError(
            f"short_kv_attention_flat kernel takes contiguous bf16 CUDA q [B,Sq,H*D], "
            f"k/v [B,I,H,K,D]; got q {tuple(q.shape)} {q.dtype}, "
            f"k {tuple(k.shape)} on {q.device}")
    o = torch.empty((b, n_id, sq, hd), dtype=q.dtype, device=q.device)
    err = cuda_lib().bya_short_kv_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, sq, n_id, h, kk, d,
        float(sm_scale), torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "short_kv_attention_flat (B2)")
    short_kv_attention_flat.launches += 1
    return o


short_kv_attention_flat.launches = 0


# ----------------------------------------------- JAX layouts: B2h, B14, B2c

def short_kv_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             sm_scale: float) -> torch.Tensor:
    """The JAX `_spec_attend`: q [G, H, Sq, D], k/v [G, I, H, K, D] ->
    [G, I, H, Sq, D]; fp32 scores and softmax, p rounded to v's dtype."""
    s = torch.einsum("ghqd,gihkd->gihqk", q.float(), k.float()) * sm_scale
    return torch.einsum("gihqk,gihkd->gihqd", torch.softmax(s, dim=-1).to(v.dtype), v)


def short_kv_attention_combined_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                      w: torch.Tensor, sm_scale: float) -> torch.Tensor:
    """Plain version of B2c (the JAX `_spec_combined`): -> [G, H, Sq, D]."""
    o = short_kv_attention_plain(q, k, v, sm_scale)
    return torch.einsum("gihqd,gqi->ghqd", o, w.to(o.dtype))


def short_kv_attention_qmajor_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                    sm_scale: float) -> torch.Tensor:
    """Plain version of B14 per identity (the JAX `_spec_attend_qmajor`):
    q [G, Sq, H, D] -> [G, I, Sq, H, D]."""
    s = torch.einsum("gqhd,gihkd->gihqk", q.float(), k.float()) * sm_scale
    return torch.einsum("gihqk,gihkd->giqhd", torch.softmax(s, dim=-1).to(v.dtype), v)


def short_kv_attention_combined_qmajor_plain(q: torch.Tensor, k: torch.Tensor,
                                             v: torch.Tensor, w: torch.Tensor,
                                             sm_scale: float) -> torch.Tensor:
    """Plain version of B14 combined (the JAX `_spec_combined_qmajor`):
    -> [G, Sq, H, D]."""
    o = short_kv_attention_qmajor_plain(q, k, v, sm_scale)
    return torch.einsum("giqhd,gqi->gqhd", o, w.to(o.dtype))


def _layout_kernel(q, k, v, w: Optional[torch.Tensor], sm_scale: float,
                   qmajor: bool) -> torch.Tensor:
    """Launch B14 (q-major), B2c or B2h (head-major; per identity when `w`
    is None)."""
    if qmajor:
        g, sq, h, d = q.shape
    else:
        g, h, sq, d = q.shape
    n_id, kk = k.shape[1], k.shape[3]
    short_kv_body(d)
    tensors = (q, k, v) if w is None else (q, k, v, w)
    ok = (q.device.type == "cuda" and k.shape == (g, n_id, h, kk, d) and v.shape == k.shape
          and (w is None or w.shape == (g, sq, n_id)) and _kernel_dtype_ok(*tensors))
    if not ok:
        lay = "[G,Sq,H,D]" if qmajor else "[G,H,Sq,D]"
        raise ValueError(
            f"short-KV {'q-major' if qmajor else 'head-major'} kernel takes contiguous bf16 "
            f"CUDA q {lay}, k/v [G,I,H,K,D], w [G,Sq,I]; "
            f"got q {tuple(q.shape)} {q.dtype}, k {tuple(k.shape)} on {q.device}")
    if w is not None:
        o = torch.empty_like(q)
    else:
        o = torch.empty((g, n_id, sq, h, d) if qmajor else (g, n_id, h, sq, d),
                        dtype=q.dtype, device=q.device)
    err = cuda_lib().bya_short_kv_layout(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None if w is None else w.data_ptr(),
        o.data_ptr(), g, sq, n_id, h, kk, d, int(qmajor), float(sm_scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "short_kv_attention (B14)" if qmajor else "short_kv_attention (B2c/B2h)")
    return o


def short_kv_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       sm_scale: float) -> torch.Tensor:
    """Per-identity cross-attention (the JAX `short_kv_attention`): q
    [G, H, Sq, D], k/v [G, I, H, K, D] -> [G, I, H, Sq, D].  A CPU tensor
    takes the plain version; a CUDA tensor launches kernel B2h, B2's body
    in the head-major layout (bf16, D % 8 == 0 up to 256, any K and I), or
    raises."""
    if q.device.type == "cpu":
        return short_kv_attention_plain(q, k, v, sm_scale)
    return kernel_with_plain_vjp(_headmajor_kernel, short_kv_attention_plain, (q, k, v),
                                 (sm_scale,))


def _headmajor_kernel(q, k, v, sm_scale: float) -> torch.Tensor:
    o = _layout_kernel(q, k, v, None, sm_scale, qmajor=False)
    short_kv_attention.launches += 1
    return o


short_kv_attention.launches = 0


def short_kv_attention_combined(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                w: torch.Tensor, sm_scale: float) -> torch.Tensor:
    """Identity-combined cross-attention (the JAX
    `short_kv_attention_combined`): q [G, H, Sq, D], k/v [G, I, H, K, D],
    w [G, Sq, I] -> sum_i w_i * attn_i as [G, H, Sq, D].  A CPU tensor
    takes the plain version; a CUDA tensor launches kernel B2c (bf16,
    D % 8 == 0 up to 256, any K and I) or raises."""
    if q.device.type == "cpu":
        return short_kv_attention_combined_plain(q, k, v, w, sm_scale)
    return kernel_with_plain_vjp(_combined_kernel, short_kv_attention_combined_plain,
                                 (q, k, v, w), (sm_scale,))


def _combined_kernel(q, k, v, w, sm_scale: float) -> torch.Tensor:
    o = _layout_kernel(q, k, v, w, sm_scale, qmajor=False)
    short_kv_attention_combined.launches += 1
    return o


short_kv_attention_combined.launches = 0


def short_kv_attention_qmajor(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              sm_scale: float) -> torch.Tensor:
    """Per-identity cross-attention, q-major IO (the JAX
    `short_kv_attention_qmajor`): q [G, Sq, H, D], k/v [G, I, H, K, D] ->
    [G, I, Sq, H, D].  A CPU tensor takes the plain version; a CUDA tensor
    launches kernel B14 (bf16, D % 8 == 0 up to 256, any K and I) or
    raises.
    `short_kv_attention_qmajor.launches` counts B14 in both modes."""
    if q.device.type == "cpu":
        return short_kv_attention_qmajor_plain(q, k, v, sm_scale)
    return kernel_with_plain_vjp(_qmajor_kernel, short_kv_attention_qmajor_plain, (q, k, v),
                                 (sm_scale,))


def short_kv_attention_combined_qmajor(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                       w: torch.Tensor, sm_scale: float) -> torch.Tensor:
    """Identity-combined cross-attention, q-major IO (the JAX
    `short_kv_attention_combined_qmajor`): q [G, Sq, H, D], k/v
    [G, I, H, K, D], w [G, Sq, I] -> [G, Sq, H, D] through kernel B14."""
    if q.device.type == "cpu":
        return short_kv_attention_combined_qmajor_plain(q, k, v, w, sm_scale)
    return kernel_with_plain_vjp(_qmajor_combined_kernel,
                                 short_kv_attention_combined_qmajor_plain, (q, k, v, w),
                                 (sm_scale,))


def _qmajor_kernel(q, k, v, sm_scale: float) -> torch.Tensor:
    o = _layout_kernel(q, k, v, None, sm_scale, qmajor=True)
    short_kv_attention_qmajor.launches += 1
    return o


def _qmajor_combined_kernel(q, k, v, w, sm_scale: float) -> torch.Tensor:
    o = _layout_kernel(q, k, v, w, sm_scale, qmajor=True)
    short_kv_attention_qmajor.launches += 1
    return o


short_kv_attention_qmajor.launches = 0

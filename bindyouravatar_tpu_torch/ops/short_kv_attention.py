"""Long-query / short-KV cross-attention: kernels B2 and B3.

Both kernels (`csrc/short_kv_attention.cu`) replace TPU kernels of
`bindyouravatar_tpu/ops/short_kv_attention.py`; the source notes say what
bounds them on the H100.
  * B3 (`_kernel_flat`), with the identity combine: the audio
    cross-attention calls it once per layer; every latent frame's 1,350
    video queries attend to that frame's 32 audio tokens of each identity,
    and the per-identity results are summed with the routing weights.
  * B2 (`_kernel`, `combine=False`): the perceiver face injection calls it
    once per face layer; all 17,550 video queries attend to each identity's
    32 face tokens, one output per identity, combined later by the caller.
Their gradients take the vjp of the plain versions, recomputed from the
saved inputs (B3's routing weights `w` included), as the JAX custom vjps
`_bwd_a` and `_bwd_cf` do: the JAX package has no Pallas backward here.
"""

from __future__ import annotations

import torch

from ._build import check, cuda_lib
from .autograd import kernel_with_plain_vjp


def short_kv_attention_combined_flat_plain(q: torch.Tensor, k: torch.Tensor,
                                           v: torch.Tensor, w: torch.Tensor,
                                           sm_scale: float) -> torch.Tensor:
    """Plain version of B3 (the JAX `_spec_combined_flat`)."""
    g, sq, hd = q.shape
    h, d = k.shape[2], k.shape[4]
    qh = q.reshape(g, sq, h, d)
    s = torch.einsum("gqhd,gihkd->gihqk", qh.float(), k.float()) * sm_scale
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("gihqk,gihkd->giqhd", p.to(v.dtype), v)
    out = torch.einsum("giqhd,gqi->gqhd", o, w.to(o.dtype))
    return out.reshape(g, sq, hd)


def short_kv_attention_combined_flat(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                     w: torch.Tensor, sm_scale: float) -> torch.Tensor:
    """q [G, Sq, H*D], k/v [G, I, H, K, D], w [G, Sq, I] ->
    sum_i w_i * softmax(q k_i^T * sm_scale) v_i as [G, Sq, H*D].  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel
    (bf16, D = 64, K = 32 tokens per identity, I <= 4) or raises."""
    if q.device.type == "cpu":
        return short_kv_attention_combined_flat_plain(q, k, v, w, sm_scale)
    return kernel_with_plain_vjp(_combined_flat_kernel, short_kv_attention_combined_flat_plain,
                                 (q, k, v, w), (sm_scale,))


def _combined_flat_kernel(q, k, v, w, sm_scale: float) -> torch.Tensor:
    g, sq, hd = q.shape
    n_id, h, kk, d = k.shape[1], k.shape[2], k.shape[3], k.shape[4]
    ok = (q.device.type == "cuda" and d == 64 and hd == h * d and kk == 32
          and 1 <= n_id <= 4 and k.shape == (g, n_id, h, kk, d) and v.shape == k.shape
          and w.shape == (g, sq, n_id)
          and all(t.dtype == torch.bfloat16 and t.is_contiguous() and t.data_ptr() % 16 == 0
                  for t in (q, k, v, w)))
    if not ok:
        raise ValueError(
            f"short_kv_attention kernel takes contiguous bf16 CUDA q [G,Sq,H*64], "
            f"k/v [G,I,H,32,64] with I <= 4, w [G,Sq,I]; got "
            f"q {tuple(q.shape)} {q.dtype}, k {tuple(k.shape)}, w {tuple(w.shape)} "
            f"on {q.device}")
    o = torch.empty_like(q)
    err = cuda_lib().bya_short_kv_attention_combined_flat(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), o.data_ptr(),
        g, sq, n_id, h, kk, float(sm_scale), torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "short_kv_attention_combined_flat (B3)")
    short_kv_attention_combined_flat.launches += 1
    return o


short_kv_attention_combined_flat.launches = 0


def short_kv_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             sm_scale: float) -> torch.Tensor:
    """Plain version of B2 (the JAX `_spec_attend`, with flat q and output)."""
    b, sq, hd = q.shape
    n_id, h, d = k.shape[1], k.shape[2], k.shape[4]
    qh = q.reshape(b, sq, h, d)
    s = torch.einsum("bqhd,bihkd->bihqk", qh.float(), k.float()) * sm_scale
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bihqk,bihkd->biqhd", p.to(v.dtype), v)
    return o.reshape(b, n_id, sq, hd)


def short_kv_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       sm_scale: float) -> torch.Tensor:
    """q [B, Sq, H*D], k/v [B, I, H, K, D] -> softmax(q k_i^T * sm_scale) v_i
    per identity as [B, I, Sq, H*D].  A CPU tensor takes the plain version;
    a CUDA tensor launches kernel B2 (bf16, D = 128, K = 32 tokens per
    identity, I <= 4) or raises."""
    if q.device.type == "cpu":
        return short_kv_attention_plain(q, k, v, sm_scale)
    return kernel_with_plain_vjp(_short_kv_kernel, short_kv_attention_plain, (q, k, v),
                                 (sm_scale,))


def _short_kv_kernel(q, k, v, sm_scale: float) -> torch.Tensor:
    b, sq, hd = q.shape
    n_id, h, kk, d = k.shape[1], k.shape[2], k.shape[3], k.shape[4]
    ok = (q.device.type == "cuda" and d == 128 and hd == h * d and kk == 32
          and 1 <= n_id <= 4 and k.shape == (b, n_id, h, kk, d) and v.shape == k.shape
          and all(t.dtype == torch.bfloat16 and t.is_contiguous() and t.data_ptr() % 16 == 0
                  for t in (q, k, v)))
    if not ok:
        raise ValueError(
            f"short_kv_attention kernel takes contiguous bf16 CUDA q [B,Sq,H*128], "
            f"k/v [B,I,H,32,128] with I <= 4; got q {tuple(q.shape)} {q.dtype}, "
            f"k {tuple(k.shape)} on {q.device}")
    o = torch.empty((b, n_id, sq, hd), dtype=q.dtype, device=q.device)
    err = cuda_lib().bya_short_kv_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, sq, n_id, h, kk,
        float(sm_scale), torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "short_kv_attention (B2)")
    short_kv_attention.launches += 1
    return o


short_kv_attention.launches = 0

"""Fused single-pass row LayerNorm: kernel B6 (Triton) and its plain version.

Replaces the TPU kernel `_ln_kernel` (bindyouravatar_tpu/ops/layernorm.py),
reached through `fused_layernorm` from `LayerNorm(fused=True)`: the audio
`norm_q` over [B*S, 3072] in every audio layer and the `AudioProjModel`
norm over [.., 768] once per clip.

What bounds it on the H100: memory.  It reads and writes each bf16 element
once (4 B/element) for ~8 FLOP/element, far below the card's ~295 FLOP/B
ridge; the kernel (`_ln_triton.ln_fwd_kernel`) keeps the whole row in
registers, so the fp32 statistics and the affine cost no extra traffic.
"""

from __future__ import annotations

import torch

from ._build import import_triton

# widths the kernel takes: whole rows in registers, 128-element multiples
_MAX_D = 8192


def layernorm_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dim with fp32 statistics and affine,
    returning x.dtype (the JAX `_ln_ref`)."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def fused_layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """Row LayerNorm of `x` ([..., D]).  A CPU tensor takes the plain
    version; a CUDA tensor launches kernel B6 (bf16, D % 128 == 0,
    D <= 8192) or raises.  Triton raises itself if a launch fails."""
    if x.device.type == "cpu":
        return layernorm_plain(x, scale, bias, eps)
    d = x.shape[-1]
    if x.device.type != "cuda" or x.dtype != torch.bfloat16 or d % 128 or d > _MAX_D:
        raise ValueError(f"fused_layernorm kernel takes bf16 CUDA rows with "
                         f"D % 128 == 0 and D <= {_MAX_D}; got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")
    import_triton()
    from ._ln_triton import ln_fwd_kernel

    x2 = x.reshape(-1, d).contiguous()
    y = torch.empty_like(x2)
    block = 1 << (d - 1).bit_length()
    ln_fwd_kernel[(x2.shape[0],)](
        x2, scale.float().contiguous(), bias.float().contiguous(), y, d, eps,
        BLOCK=block, num_warps=8 if block >= 4096 else 4)
    fused_layernorm.launches += 1
    return y.view(x.shape)


fused_layernorm.launches = 0

"""EVA02-CLIP-L-14-336 visual tower in torch (port of
`bindyouravatar_tpu/models/eva_clip.py`).

The face stack's CLIP tower: 336 px / patch 14 -> 576 + 1 tokens, width
1024, 24 blocks of 16 heads, SwiGLU (mlp_ratio 2.6667) with its FFN
LayerNorm, separate q/k/v projections (k without bias), the inner
attention LayerNorm, a 2-D axial rotary embedding on the 576 patch rows
(not the CLS row) in the rotate-half convention, an absolute position
embedding and a CLS token.  It returns the pooled projection [B, 768] and
the hidden states entering blocks 4, 8, 12, 16 and 20, [B, 5, 577, 1024]:
`id_cond`'s second half and `id_vit_hidden`.  Attention is the port's
`ops/attention.sdpa` (577 tokens; JAX calls its XLA `sdpa` here, no Pallas
kernel), and the LayerNorms are the unfused ones with fp32 statistics, as
in JAX.  Parameter names follow the flax tree (`block_{i}.attn.q_proj`,
`ffn_ln`, ...); `cls_token` and `pos_embed` are raw params.
`eva_state_dict` reads the reference checkpoint's names (the port's copy of
the JAX package's `training/import_encoders.py:import_eva_vision`), with
its q/k channel permutation from EVA's interleaved RoPE pairs into the
rotate-half convention.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import EVACLIPConfig
from ..ops.attention import sdpa
from ..ops.rope import apply_rotary_emb
from .layers import Dense, LayerNorm, init_random_


def _vision_rope_tables(grid: int, dim_half: int, pt_seq_len: int = 16,
                        theta: float = 10000.0) -> Tuple[np.ndarray, np.ndarray]:
    """2-D axial RoPE (EVA `VisionRotaryEmbeddingFast` semantics): per axis
    `dim_half / 2` frequencies over positions scaled to the pretrain grid;
    cos/sin [grid^2, 2 * dim_half] float32, rotate-half layout."""
    freqs = 1.0 / (theta ** (np.arange(0, dim_half, 2, dtype=np.float64) / dim_half))
    t = np.arange(grid, dtype=np.float64) / grid * pt_seq_len
    ang = np.outer(t, freqs)                                  # [G, dim_half/2]
    hh = np.broadcast_to(ang[:, None, :], (grid, grid, ang.shape[-1]))
    ww = np.broadcast_to(ang[None, :, :], (grid, grid, ang.shape[-1]))
    full = np.concatenate([hh, ww], axis=-1).reshape(grid * grid, dim_half)
    cos = np.concatenate([np.cos(full), np.cos(full)], axis=-1)
    sin = np.concatenate([np.sin(full), np.sin(full)], axis=-1)
    return cos.astype(np.float32), sin.astype(np.float32)


class _Conv2d(nn.Conv2d):
    """nn.Conv2d that computes in `compute_dtype` (flax `nn.Conv(dtype=...)`)."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.bfloat16, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        return self._conv_forward(x.to(cd), self.weight.to(cd), self.bias.to(cd))


class EVAAttention(nn.Module):
    def __init__(self, cfg: EVACLIPConfig):
        super().__init__()
        c = self.cfg = cfg
        kw = dict(compute_dtype=c.dtype, dtype=c.param_dtype)
        self.q_proj = Dense(c.width, c.width, **kw)
        self.k_proj = Dense(c.width, c.width, bias=False, **kw)
        self.v_proj = Dense(c.width, c.width, **kw)
        self.inner_attn_ln = LayerNorm(c.width, eps=1e-6, dtype=c.param_dtype)
        self.proj = Dense(c.width, c.width, **kw)

    def forward(self, x: torch.Tensor,
                rope: Optional[Tuple[torch.Tensor, torch.Tensor]]) -> torch.Tensor:
        c = self.cfg
        b, s, _ = x.shape
        heads = lambda t: t.reshape(b, s, c.heads, -1).transpose(1, 2)
        q, k, v = heads(self.q_proj(x)), heads(self.k_proj(x)), heads(self.v_proj(x))
        if rope is not None:
            cos, sin = rope
            q = torch.cat([q[:, :, :1], apply_rotary_emb(q[:, :, 1:], cos, sin)], 2)
            k = torch.cat([k[:, :, :1], apply_rotary_emb(k[:, :, 1:], cos, sin)], 2)
        o = sdpa(q, k, v).transpose(1, 2).reshape(b, s, c.width)
        return self.proj(self.inner_attn_ln(o))


class EVABlock(nn.Module):
    def __init__(self, cfg: EVACLIPConfig):
        super().__init__()
        c = cfg
        kw = dict(compute_dtype=c.dtype, dtype=c.param_dtype)
        hidden = int(c.width * c.mlp_ratio)
        self.norm1 = LayerNorm(c.width, eps=1e-6, dtype=c.param_dtype)
        self.attn = EVAAttention(c)
        self.norm2 = LayerNorm(c.width, eps=1e-6, dtype=c.param_dtype)
        self.w1 = Dense(c.width, hidden, **kw)
        self.w2 = Dense(c.width, hidden, **kw)
        self.ffn_ln = LayerNorm(hidden, eps=1e-6, dtype=c.param_dtype)
        self.w3 = Dense(hidden, c.width, **kw)

    def forward(self, x, rope):
        x = x + self.attn(self.norm1(x), rope)
        h = self.norm2(x)
        return x + self.w3(self.ffn_ln(F.silu(self.w1(h)) * self.w2(h)))


class EVAVisionTower(nn.Module):
    """images [B, 3, H, W] (CLIP-normalised) -> (pooled [B, out_dim],
    hidden [B, n_taps, S, width]), both in `cfg.dtype`."""

    def __init__(self, cfg: EVACLIPConfig = EVACLIPConfig()):
        super().__init__()
        c = self.cfg = cfg
        self.patch_embed = _Conv2d(3, c.width, c.patch_size, stride=c.patch_size,
                                   compute_dtype=c.dtype, dtype=c.param_dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c.width, dtype=c.param_dtype))
        self.pos_embed = nn.Parameter(torch.zeros(1, c.seq_len, c.width, dtype=c.param_dtype))
        for i in range(c.depth):
            self.add_module(f"block_{i}", EVABlock(c))
        self.norm = LayerNorm(c.width, eps=1e-6, dtype=c.param_dtype)
        self.head = Dense(c.width, c.out_dim, compute_dtype=c.dtype, dtype=c.param_dtype)

    @classmethod
    def create(cls, cfg: EVACLIPConfig = EVACLIPConfig(), device: torch.device | str = "cuda",
               generator: Optional[torch.Generator] = None) -> "EVAVisionTower":
        """Build on `device` (the card unless the caller asks for another);
        with a `generator` the weights are drawn from it (`init_random_`;
        `cls_token` and `pos_embed` ~ N(0, 0.02)), else left for
        `load_state_dict`."""
        with torch.device("meta"):
            model = cls(cfg)
        model = model.to_empty(device=device)
        if generator is not None:
            init_random_(model, generator)
            with torch.no_grad():
                model.cls_token.normal_(0.0, 0.02, generator=generator)
                model.pos_embed.normal_(0.0, 0.02, generator=generator)
        return model.eval()

    @classmethod
    def tiny(cls, device: torch.device | str = "cuda",
             generator: Optional[torch.Generator] = None) -> "EVAVisionTower":
        """The JAX `EVACLIPVision.tiny` shapes, in fp32."""
        return cls.create(EVACLIPConfig(image_size=28, patch_size=14, width=32, depth=6,
                                        heads=4, out_dim=16, hidden_taps=(1, 2, 3, 4, 5),
                                        pt_hw_seq_len=2, dtype=torch.float32),
                          device, generator)

    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        c = self.cfg
        b = images.shape[0]
        x = self.patch_embed(images).flatten(2).transpose(1, 2)
        x = torch.cat([self.cls_token.to(c.dtype).expand(b, -1, -1), x], 1)
        x = x + self.pos_embed.to(c.dtype)
        rope = None
        if c.use_rope:
            rope = tuple(torch.from_numpy(t).to(x.device) for t in
                         _vision_rope_tables(c.grid, c.width // c.heads // 2, c.pt_hw_seq_len))
        taps = []
        for i in range(c.depth):
            if i in c.hidden_taps:
                taps.append(x)
            x = getattr(self, f"block_{i}")(x, rope)
        pooled = self.head(self.norm(x)[:, 0])
        return pooled, torch.stack(taps, dim=1)


def eva_state_dict(sd: Dict[str, torch.Tensor],
                   cfg: EVACLIPConfig = EVACLIPConfig()) -> Dict[str, torch.Tensor]:
    """An EVA02-CLIP visual-tower state dict (the reference's vendored
    package names, `visual.`-prefixed or not) -> the port's names, fp32 (JAX's
    `import_eva_vision` followed by `convert.jax_params_to_torch`).  EVA
    rotates interleaved channel pairs; the tower rotates halves, so the
    rows of W_q, q_bias and W_k are permuted per head, evens then odds."""
    pre = "visual." if any(k.startswith("visual.") for k in sd) else ""
    g = lambda k: sd[pre + k].float()
    dh = cfg.width // cfg.heads
    p1 = np.concatenate([np.arange(0, dh, 2), np.arange(1, dh, 2)])
    perm = torch.from_numpy(np.concatenate([p1 + h * dh for h in range(cfg.heads)])
                            if cfg.use_rope else np.arange(cfg.width))
    out = {"patch_embed.weight": g("patch_embed.proj.weight"),
           "patch_embed.bias": g("patch_embed.proj.bias"),
           "cls_token": g("cls_token"), "pos_embed": g("pos_embed"),
           "norm.weight": g("norm.weight"), "norm.bias": g("norm.bias"),
           "head.weight": g("head.weight"), "head.bias": g("head.bias")}
    for i in range(cfg.depth):
        b, p = f"blocks.{i}", f"block_{i}"
        out.update({
            f"{p}.attn.q_proj.weight": g(f"{b}.attn.q_proj.weight")[perm],
            f"{p}.attn.q_proj.bias": g(f"{b}.attn.q_bias")[perm],
            f"{p}.attn.k_proj.weight": g(f"{b}.attn.k_proj.weight")[perm],
            f"{p}.attn.v_proj.weight": g(f"{b}.attn.v_proj.weight"),
            f"{p}.attn.v_proj.bias": g(f"{b}.attn.v_bias")})
        for ours, theirs in (("norm1", "norm1"), ("norm2", "norm2"),
                             ("attn.inner_attn_ln", "attn.inner_attn_ln"),
                             ("attn.proj", "attn.proj"), ("w1", "mlp.w1"), ("w2", "mlp.w2"),
                             ("ffn_ln", "mlp.ffn_ln"), ("w3", "mlp.w3")):
            out[f"{p}.{ours}.weight"] = g(f"{b}.{theirs}.weight")
            out[f"{p}.{ours}.bias"] = g(f"{b}.{theirs}.bias")
    return out


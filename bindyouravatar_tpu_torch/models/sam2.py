"""SAM2 (Segment Anything 2.1) in torch: the port of
`bindyouravatar_tpu/models/sam2.py`, the network of the two-stage
generate's mask tool.

Hiera backbone (patch embed 7x7/4, windowed attention with 2x2 q-pooling
at each stage's first block, a few global blocks), FPN neck to `d_model`
with the /32 level dropped, the SAM prompt encoder, the two-way-transformer
mask decoder with its object-score token and multimask slots, the ConvNeXt
memory encoder and the RoPE memory attention.  Feature maps are NHWC, as in
JAX; the image input is NCHW.  Attention is plain PyTorch
(`F.scaled_dot_product_attention`, which accumulates the scores in fp32 as
JAX's `preferred_element_type` asks): no Pallas kernel stands behind JAX's
einsum + softmax.

The modules carry sam2.1's parameter names (`image_encoder.trunk.blocks.0.
attn.qkv.weight`, `sam_mask_decoder.output_upscaling.1.bias`,
`memory_encoder.mask_downsampler.encoder.3.weight`, ...), so a state dict
in the layout JAX's importer reads (`preprocess/sam2_video.py:
import_sam2_weights`) loads with `strict=True`.  Two layouts follow JAX's
importer rather than the sam2 package: the mask decoder's 2x2 transposed
convs keep their weights as [out, in, 2, 2] and apply flax's
`ConvTranspose` (the kernel taps mirrored), and the neck's `convs.i` take
the trunk's stage i.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

LN_EPS = 1e-6     # every LayerNorm of the JAX model (flax's default and Hiera's)


# ------------------------------------------------------------------ #
# config

@dataclasses.dataclass(frozen=True)
class HieraConfig:
    embed_dim: int = 144
    num_heads: int = 2
    stages: Tuple[int, ...] = (2, 6, 36, 4)
    global_att_blocks: Tuple[int, ...] = (23, 33, 43)
    window_spec: Tuple[int, ...] = (8, 4, 16, 8)
    window_pos_embed_bkg_spatial_size: Tuple[int, int] = (7, 7)

    @classmethod
    def large(cls) -> "HieraConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "HieraConfig":
        """sam2.1_hiera_tiny geometry."""
        return cls(embed_dim=96, num_heads=1, stages=(1, 2, 7, 2),
                   global_att_blocks=(5, 7, 9), window_spec=(8, 4, 14, 7))

    @classmethod
    def test(cls) -> "HieraConfig":
        """Miniature for unit tests."""
        return cls(embed_dim=16, num_heads=1, stages=(1, 1, 1, 1), global_att_blocks=(2,),
                   window_spec=(4, 2, 2, 2), window_pos_embed_bkg_spatial_size=(7, 7))

    @property
    def stage_dims(self) -> Tuple[int, ...]:
        return tuple(self.embed_dim * 2 ** i for i in range(len(self.stages)))


@dataclasses.dataclass(frozen=True)
class SAM2Config:
    hiera: HieraConfig = HieraConfig()
    d_model: int = 256
    mem_dim: int = 64
    num_maskmem: int = 7                 # 1 cond + 6 recent
    image_size: int = 1024
    backbone_stride: int = 16
    num_multimask: int = 3
    memory_attn_layers: int = 4
    memory_attn_heads: int = 1
    memory_attn_kv_dim: int = 256
    max_obj_ptrs: int = 16

    @classmethod
    def tiny_test(cls) -> "SAM2Config":
        return cls(hiera=HieraConfig.test(), d_model=32, mem_dim=16, image_size=128,
                   memory_attn_layers=1, num_multimask=3)


# ------------------------------------------------------------------ #
# shared bits

class LayerNorm2d(nn.Module):
    """Channel LayerNorm over NHWC's last dim (sam2's LayerNorm2d on NCHW)."""

    def __init__(self, dim: int, eps: float = LN_EPS):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, x.shape[-1:], self.weight, self.bias, self.eps)


def layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=LN_EPS)


class MLP(nn.Module):
    """SAM-style n-layer MLP, relu between: `layers.{i}`."""

    def __init__(self, din: int, hidden: int, out: int, layers: int = 3):
        super().__init__()
        dims = [din] + [hidden] * (layers - 1) + [out]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers[:-1]:
            x = F.relu(layer(x))
        return self.layers[-1](x)


def conv_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """An `nn.Conv2d` (torch weight layout) on an NHWC tensor."""
    if conv.kernel_size == (1, 1) and conv.stride == (1, 1) and conv.groups == 1:
        return F.linear(x, conv.weight.flatten(1), conv.bias)
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def _interp_bilinear(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """NHWC bilinear resize, align_corners=False with the antialiasing
    kernel of `jax.image.resize` (the same weights when upsampling)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(hw), mode="bilinear",
                      align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1)


def _interp_nearest(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """NHWC nearest resize with JAX's index rule `i * ih // h`."""
    h, w = hw
    ih, iw = x.shape[1:3]
    ri = torch.arange(h, device=x.device) * ih // h
    ci = torch.arange(w, device=x.device) * iw // w
    return x[:, ri][:, :, ci]


def sine_pos_enc_2d(h: int, w: int, dim: int, temperature: float = 10000.0) -> np.ndarray:
    """[H, W, dim] sine position encoding (DETR-style, as sam2's
    PositionEmbeddingSine with normalize=True)."""
    half = dim // 2
    y = (np.arange(h, dtype=np.float64) + 1)[:, None].repeat(w, 1)
    x = (np.arange(w, dtype=np.float64) + 1)[None, :].repeat(h, 0)
    eps, scale = 1e-6, 2 * math.pi
    y = y / (h + eps) * scale
    x = x / (w + eps) * scale
    t = temperature ** (2 * (np.arange(half, dtype=np.float64) // 2) / half)
    px = x[..., None] / t
    py = y[..., None] / t
    px = np.stack([np.sin(px[..., 0::2]), np.cos(px[..., 1::2])], axis=-1).reshape(h, w, half)
    py = np.stack([np.sin(py[..., 0::2]), np.cos(py[..., 1::2])], axis=-1).reshape(h, w, half)
    return np.concatenate([py, px], axis=-1).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _sine_pos(h: int, w: int, dim: int, device: torch.device) -> torch.Tensor:
    """`sine_pos_enc_2d` as a [1, H, W, dim] float32 tensor on `device`."""
    return torch.from_numpy(sine_pos_enc_2d(h, w, dim))[None].to(device)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(dh)) v over [B, S, heads, dh] (JAX's bqhd)."""
    o = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    return o.transpose(1, 2)


def _max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """NHWC 2x2 max pool, stride 2, VALID."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


# ------------------------------------------------------------------ #
# Hiera backbone

def _window_partition(x: torch.Tensor, ws: int):
    b, h, w, c = x.shape
    ph, pw = (-h) % ws, (-w) % ws
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.reshape(b, hp // ws, ws, wp // ws, ws, c)
    wins = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, c)
    return wins, (hp, wp)


def _window_unpartition(wins: torch.Tensor, ws: int, pad_hw, hw) -> torch.Tensor:
    hp, wp = pad_hw
    h, w = hw
    b = wins.shape[0] // (hp * wp // ws // ws)
    x = wins.reshape(b, hp // ws, wp // ws, ws, ws, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w]


class MultiScaleAttention(nn.Module):
    def __init__(self, dim: int, dim_out: int, heads: int, q_pool: bool = False):
        super().__init__()
        self.qkv = nn.Linear(dim, dim_out * 3)
        self.proj = nn.Linear(dim_out, dim_out)
        self.heads, self.q_pool = heads, q_pool

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        q, k, v = self.qkv(x).reshape(b, h * w, 3, self.heads, -1).unbind(2)
        if self.q_pool:   # 2x2 max pool on q's spatial layout
            q = _max_pool_2x2(q.reshape(b, h, w, -1))
            h, w = q.shape[1:3]
            q = q.reshape(b, h * w, self.heads, -1)
        return self.proj(_attend(q, k, v).reshape(b, h, w, -1))


class MultiScaleBlock(nn.Module):
    def __init__(self, dim: int, dim_out: int, heads: int, window_size: int = 0,
                 q_stride: bool = False, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = layer_norm(dim)
        self.proj = nn.Linear(dim, dim_out) if dim != dim_out else None
        self.attn = MultiScaleAttention(dim, dim_out, heads, q_pool=q_stride)
        self.norm2 = layer_norm(dim_out)
        self.mlp = MLP(dim_out, int(dim_out * mlp_ratio), dim_out, 2)
        self.window_size, self.q_stride = window_size, q_stride   # 0 = global attention

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        h = self.norm1(x)
        if self.proj is not None:
            shortcut = self.proj(h)
        if self.q_stride:
            shortcut = _max_pool_2x2(shortcut)
        hw = h.shape[1:3]
        if self.window_size > 0:
            h, pad_hw = _window_partition(h, self.window_size)
        h = self.attn(h)
        if self.window_size > 0:
            # the windows halve with q: unpartition at half the window
            if self.q_stride:
                ws, hw = self.window_size // 2, ((hw[0] + 1) // 2, (hw[1] + 1) // 2)
                pad_hw = (pad_hw[0] // 2, pad_hw[1] // 2)
            else:
                ws = self.window_size
            h = _window_unpartition(h, ws, pad_hw, hw)
        x = shortcut + h
        y = self.norm2(x)
        y = self.mlp.layers[1](F.gelu(self.mlp.layers[0](y)))
        return x + y


class PatchEmbed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, 7, stride=4, padding=3)


class Hiera(nn.Module):
    """Returns per-stage feature maps [/4, /8, /16, /32] (NHWC)."""

    def __init__(self, cfg: HieraConfig = HieraConfig()):
        super().__init__()
        c = self.cfg = cfg
        self.patch_embed = PatchEmbed(c.embed_dim)
        self.pos_embed = nn.Parameter(
            torch.zeros((1, c.embed_dim) + tuple(c.window_pos_embed_bkg_spatial_size)))
        ws0 = c.window_spec[0]
        self.pos_embed_window = nn.Parameter(torch.zeros(1, c.embed_dim, ws0, ws0))
        q_pool_blocks = set(np.cumsum(c.stages)[:-1].tolist())
        self.stage_ends = set((np.cumsum(c.stages) - 1).tolist())
        blocks, dim, heads, idx = [], c.embed_dim, c.num_heads, 0
        for si, n in enumerate(c.stages):
            for _ in range(n):
                is_pool = idx in q_pool_blocks
                dim_out, heads = (dim * 2, heads * 2) if is_pool else (dim, heads)
                ws = 0 if idx in c.global_att_blocks else c.window_spec[si]
                blocks.append(MultiScaleBlock(dim, dim_out, heads, ws, is_pool))
                dim, idx = dim_out, idx + 1
        self.blocks = nn.ModuleList(blocks)

    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """images [B, 3, H, W] normalised."""
        x = self.patch_embed.proj(images).permute(0, 2, 3, 1)
        h, w = x.shape[1:3]
        ws = self.cfg.window_spec[0]
        pe = _interp_bilinear(self.pos_embed.permute(0, 2, 3, 1), (h, w))
        win = self.pos_embed_window.permute(0, 2, 3, 1)
        win = win.repeat(1, -(-h // ws), -(-w // ws), 1)[:, :h, :w]
        x = x + pe + win
        outs = []
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in self.stage_ends:
                outs.append(x)
        return tuple(outs)


class _Lateral(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 1)


class FpnNeck(nn.Module):
    """1x1 laterals to d_model + top-down on the chosen levels; returns
    features ordered high-res -> low-res with their sine pos encodings."""

    def __init__(self, in_dims: Sequence[int], d_model: int = 256,
                 top_down_levels: Tuple[int, ...] = (2, 3)):
        super().__init__()
        self.convs = nn.ModuleList(_Lateral(c, d_model) for c in in_dims)
        self.d_model, self.top_down_levels = d_model, top_down_levels

    def forward(self, feats: Sequence[torch.Tensor]):
        n = len(feats)
        outs: List[Optional[torch.Tensor]] = [None] * n
        prev = None
        for i in range(n - 1, -1, -1):
            x = conv_nhwc(self.convs[i].conv, feats[i])
            if i in self.top_down_levels and prev is not None:
                x = x + _interp_nearest(prev, x.shape[1:3])
            prev = outs[i] = x
        pos = [_sine_pos(o.shape[1], o.shape[2], self.d_model, o.device).to(o.dtype)
               for o in outs]
        return outs, pos


class ImageEncoder(nn.Module):
    """Hiera + FPN; drops the /32 level (sam2 `scalp=1`) and returns
    (embedding /16, high-res skips [/4, /8], pos encodings)."""

    def __init__(self, cfg: SAM2Config = SAM2Config()):
        super().__init__()
        self.trunk = Hiera(cfg.hiera)
        self.neck = FpnNeck(cfg.hiera.stage_dims, cfg.d_model)

    def forward(self, images: torch.Tensor) -> dict:
        outs, pos = self.neck(list(self.trunk(images)))
        outs, pos = outs[:-1], pos[:-1]                # scalp: drop /32
        return {"vision_features": outs[-1], "backbone_fpn": outs, "vision_pos_enc": pos}


# ------------------------------------------------------------------ #
# prompt encoder (SAM1 heritage)

class _RandomFourierPE(nn.Module):
    def __init__(self, half: int):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix", torch.zeros(2, half))

    def forward(self, coords_01: torch.Tensor) -> torch.Tensor:
        """Random-fourier position encoding of [..., 2] coords in [0, 1]."""
        g = self.positional_encoding_gaussian_matrix
        x = 2 * math.pi * ((2 * coords_01.to(g.dtype) - 1) @ g)
        return torch.cat([torch.sin(x), torch.cos(x)], dim=-1)


class PromptEncoder(nn.Module):
    """Point prompts -> sparse [B, N, D]; the no-mask dense embedding and
    the dense position encoding.  Labels: 1 positive, 0 negative, 2/3 box
    corners, -1 padding; coordinates in [0, image_size] pixels."""

    def __init__(self, cfg: SAM2Config = SAM2Config()):
        super().__init__()
        d, self.image_size, self.d_model = cfg.d_model, cfg.image_size, cfg.d_model
        self.pe_layer = _RandomFourierPE(d // 2)
        self.point_embeddings = nn.ModuleList(nn.Embedding(1, d) for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, d)
        self.no_mask_embed = nn.Embedding(1, d)

    def dense_pe(self, h: int, w: int) -> torch.Tensor:
        dev = self.no_mask_embed.weight.device
        gy = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
        gx = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
        grid = torch.stack(torch.meshgrid(gx, gy, indexing="xy"), dim=-1)
        return self.pe_layer(grid)                                 # [h, w, d]

    def forward(self, points: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """points [B, N, 2] pixels, labels [B, N] int -> sparse [B, N, D]."""
        # SAM shifts prompts to pixel centres before normalising
        pe = self.pe_layer((points + 0.5) / self.image_size)
        lab = labels[..., None]
        nap = self.not_a_point_embed.weight[0]
        out = torch.where(lab == -1, nap, pe)
        for i, emb in enumerate(self.point_embeddings):
            out = out + torch.where(lab == i, emb.weight[0], torch.zeros_like(emb.weight[0]))
        return torch.where(lab == -1, nap, out)

    def dense_no_mask(self, b: int, h: int, w: int) -> torch.Tensor:
        return self.no_mask_embed.weight[0].expand(b, h, w, self.d_model)


# ------------------------------------------------------------------ #
# two-way transformer mask decoder

class DownsampledAttention(nn.Module):
    """SAM attention with internal dim downsampling."""

    def __init__(self, dim: int, heads: int = 8, downsample: int = 1):
        super().__init__()
        inner = dim // downsample
        self.q_proj, self.k_proj, self.v_proj = (nn.Linear(dim, inner) for _ in range(3))
        self.out_proj = nn.Linear(inner, dim)
        self.heads = heads

    def forward(self, q, k, v):
        split = lambda t: t.reshape(t.shape[0], t.shape[1], self.heads, -1)
        o = _attend(split(self.q_proj(q)), split(self.k_proj(k)), split(self.v_proj(v)))
        return self.out_proj(o.flatten(2))


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, dim: int, heads: int = 8, mlp_dim: int = 2048,
                 skip_first_layer_pe: bool = False):
        super().__init__()
        self.self_attn = DownsampledAttention(dim, heads)
        self.norm1 = layer_norm(dim)
        self.cross_attn_token_to_image = DownsampledAttention(dim, heads, 2)
        self.norm2 = layer_norm(dim)
        self.mlp = MLP(dim, mlp_dim, dim, 2)
        self.norm3 = layer_norm(dim)
        self.norm4 = layer_norm(dim)
        self.cross_attn_image_to_token = DownsampledAttention(dim, heads, 2)
        self.skip_first_layer_pe = skip_first_layer_pe

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        q, k = queries + query_pe, keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))
        q, k = queries + query_pe, keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, dim: int, depth: int = 2, heads: int = 8, mlp_dim: int = 2048):
        super().__init__()
        self.layers = nn.ModuleList(
            TwoWayAttentionBlock(dim, heads, mlp_dim, skip_first_layer_pe=i == 0)
            for i in range(depth))
        self.final_attn_token_to_image = DownsampledAttention(dim, heads, 2)
        self.norm_final_attn = layer_norm(dim)

    def forward(self, image_embed, image_pe, point_embed):
        b, h, w, d = image_embed.shape
        keys = image_embed.reshape(b, h * w, d)
        key_pe = image_pe.reshape(1, h * w, d).expand_as(keys)
        queries = point_embed
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embed, key_pe)
        q, k = queries + point_embed, keys + key_pe
        queries = self.norm_final_attn(queries + self.final_attn_token_to_image(q, k, keys))
        return queries, keys


class ConvTranspose2x2(nn.Module):
    """flax's `ConvTranspose` (kernel 2, stride 2, 'SAME', no kernel
    transpose) with its weight kept as [out, in, 2, 2], the layout JAX's
    importer reads: out[2i + a, 2j + b] = x[i, j] . w[:, :, 1 - a, 1 - b]."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, 2, 2))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC -> NHWC at twice the resolution."""
        w = self.weight.transpose(0, 1).flip(2, 3)
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w, self.bias, stride=2)
        return y.permute(0, 2, 3, 1)


class MaskDecoder(nn.Module):
    """SAM2 mask decoder: multimask + iou + object-score heads, high-res
    skip fusion in the upscaler; `conv_s0` / `conv_s1` project the /4 and
    /8 skips (sam2 keeps them here)."""

    def __init__(self, cfg: SAM2Config = SAM2Config()):
        super().__init__()
        d = cfg.d_model
        self.n_masks = n = cfg.num_multimask + 1
        self.iou_token = nn.Embedding(1, d)
        self.mask_tokens = nn.Embedding(n, d)
        self.obj_score_token = nn.Embedding(1, d)
        self.transformer = TwoWayTransformer(d)
        self.output_upscaling = nn.Sequential(ConvTranspose2x2(d, d // 4), LayerNorm2d(d // 4),
                                              nn.GELU(), ConvTranspose2x2(d // 4, d // 8),
                                              nn.GELU())
        self.conv_s0 = nn.Conv2d(d, d // 8, 1)
        self.conv_s1 = nn.Conv2d(d, d // 4, 1)
        self.output_hypernetworks_mlps = nn.ModuleList(MLP(d, d, d // 8, 3) for _ in range(n))
        self.iou_prediction_head = MLP(d, d, n, 3)
        self.pred_obj_score_head = MLP(d, d, 1, 3)

    def forward(self, image_embed, image_pe, sparse_prompt, dense_prompt, high_res_feats):
        b, h, w, d = image_embed.shape
        n = self.n_masks
        tokens = torch.cat([self.obj_score_token.weight[None].expand(b, 1, d),
                            self.iou_token.weight[None].expand(b, 1, d),
                            self.mask_tokens.weight[None].expand(b, n, d),
                            sparse_prompt], dim=1)
        hs, keys = self.transformer(image_embed + dense_prompt, image_pe, tokens)
        obj_out, iou_out, mask_out = hs[:, 0], hs[:, 1], hs[:, 2:2 + n]

        f_s0, f_s1 = high_res_feats
        up0, ln, _, up3, _ = self.output_upscaling
        up = F.gelu(ln(up0(keys.reshape(b, h, w, d)) + f_s1))
        up = F.gelu(up3(up) + f_s0)                               # [B, 4h, 4w, d/8]
        hyper = torch.stack([mlp(mask_out[:, i])
                             for i, mlp in enumerate(self.output_hypernetworks_mlps)], dim=1)
        masks = torch.einsum("bnc,bhwc->bnhw", hyper, up)
        # the SAM token out is the object pointer's source
        return (masks, self.iou_prediction_head(iou_out), self.pred_obj_score_head(obj_out),
                mask_out)


# ------------------------------------------------------------------ #
# memory subsystem

class CXBlock(nn.Module):
    """ConvNeXt block (memory fuser)."""

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = LayerNorm2d(dim)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), 1e-6))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.norm(conv_nhwc(self.dwconv, x))
        return x + self.gamma * self.pwconv2(F.gelu(self.pwconv1(h)))


class MaskDownSampler(nn.Module):
    """4 x (3x3 stride-2 conv, LayerNorm2d, GELU) from full image
    resolution to /16 (channels 1 -> 4 -> 16 -> 64 -> 256, capped at
    d_model), then a 1x1 conv: sam2's `encoder.{3i, 3i + 1, 3i + 2}` and
    `encoder.12`."""

    def __init__(self, d_model: int, steps: int = 4):
        super().__init__()
        layers, cin, ch = [], 1, 4
        for _ in range(steps):
            layers += [nn.Conv2d(cin, ch, 3, stride=2, padding=1), LayerNorm2d(ch), nn.GELU()]
            cin, ch = ch, min(ch * 4, d_model)
        layers.append(nn.Conv2d(cin, d_model, 1))
        self.encoder = nn.Sequential(*layers)

    def forward(self, m: torch.Tensor) -> torch.Tensor:
        """NHWC [B, 16h, 16w, 1] -> [B, h, w, d_model]."""
        for i in range(0, len(self.encoder) - 1, 3):
            m = F.gelu(self.encoder[i + 1](conv_nhwc(self.encoder[i], m)))
        return conv_nhwc(self.encoder[-1], m)


class _Fuser(nn.Module):
    def __init__(self, dim: int, n: int = 2):
        super().__init__()
        self.layers = nn.ModuleList(CXBlock(dim) for _ in range(n))


class MemoryEncoder(nn.Module):
    """(pix features /16, predicted mask logits) -> memory features
    [B, h, w, mem_dim] + sine pos enc."""

    def __init__(self, cfg: SAM2Config = SAM2Config()):
        super().__init__()
        self.stride = cfg.backbone_stride
        self.mask_downsampler = MaskDownSampler(cfg.d_model, int(math.log2(cfg.backbone_stride)))
        self.pix_feat_proj = nn.Conv2d(cfg.d_model, cfg.d_model, 1)
        self.fuser = _Fuser(cfg.d_model)
        self.out_proj = nn.Conv2d(cfg.d_model, cfg.mem_dim, 1)
        self.mem_dim = cfg.mem_dim

    def forward(self, pix_feat: torch.Tensor, mask_logits: torch.Tensor):
        # sam2 downsamples the sigmoid'd mask from FULL image resolution by
        # the total stride; decoder logits arrive at /4, so upsample first
        m = torch.sigmoid(mask_logits)[..., None]                 # [B, h4, w4, 1]
        full = (pix_feat.shape[1] * self.stride, pix_feat.shape[2] * self.stride)
        if tuple(m.shape[1:3]) != full:
            m = _interp_bilinear(m, full)
        x = conv_nhwc(self.pix_feat_proj, pix_feat) + self.mask_downsampler(m)
        for blk in self.fuser.layers:
            x = blk(x)
        x = conv_nhwc(self.out_proj, x)
        pos = _sine_pos(x.shape[1], x.shape[2], self.mem_dim, x.device).to(x.dtype)
        return x, pos.expand_as(x)


def _rope_2d_tables(h: int, w: int, dim: int, theta: float = 10000.0):
    """Axial 2D RoPE cos/sin tables [h*w, dim//2] (half for y, half for x)."""
    quarter = dim // 4
    freqs = 1.0 / theta ** (np.arange(quarter, dtype=np.float64) / quarter)
    ty = np.arange(h, dtype=np.float64)[:, None] * freqs[None]
    tx = np.arange(w, dtype=np.float64)[:, None] * freqs[None]
    ang = np.concatenate([np.broadcast_to(ty[:, None], (h, w, quarter)),
                          np.broadcast_to(tx[None, :], (h, w, quarter))], axis=-1)
    ang = ang.reshape(h * w, dim // 2)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _rope_tables(h: int, w: int, dim: int, device: torch.device):
    return tuple(torch.from_numpy(t).to(device) for t in _rope_2d_tables(h, w, dim))


def _apply_rope_interleaved(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x [..., S, D]; rotate the pairs (x0, x1), (x2, x3), ... by cos/sin
    [S, D/2] (interleaved: not the DiT's rotate-half)."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).reshape(x.shape)


class RoPEAttention(nn.Module):
    """Memory attention with axial RoPE on the spatial tokens.

    `rope_k_rows`: the number of leading k rows that are spatial (rotated,
    the table repeated per memory frame); the trailing rows (object
    pointers) stay unrotated, as do q rows past the table."""

    def __init__(self, dim: int, heads: int, kv_in_dim: Optional[int] = None):
        super().__init__()
        kv = kv_in_dim or dim
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(kv, dim)
        self.v_proj = nn.Linear(kv, dim)
        self.out_proj = nn.Linear(dim, dim)
        self.dim, self.heads = dim, heads

    def forward(self, q, k, v, hw_q, hw_k, rope_k_rows=None):
        dh, b = self.dim // self.heads, q.shape[0]
        heads = lambda t: t.reshape(b, -1, self.heads, dh).transpose(1, 2)
        qp, kp, vp = heads(self.q_proj(q)), heads(self.k_proj(k)), heads(self.v_proj(v))
        cos_q, sin_q = (t.to(qp.dtype) for t in _rope_tables(hw_q[0], hw_q[1], dh, qp.device))
        nq = hw_q[0] * hw_q[1]
        qp = torch.cat([_apply_rope_interleaved(qp[:, :, :nq], cos_q, sin_q), qp[:, :, nq:]], 2)
        if rope_k_rows is None:
            rope_k_rows = kp.shape[2]
        reps = rope_k_rows // (hw_k[0] * hw_k[1])
        cos_k, sin_k = (t.to(kp.dtype).repeat(reps, 1)
                        for t in _rope_tables(hw_k[0], hw_k[1], dh, kp.device))
        kp = torch.cat([_apply_rope_interleaved(kp[:, :, :rope_k_rows], cos_k, sin_k),
                        kp[:, :, rope_k_rows:]], 2)
        o = F.scaled_dot_product_attention(qp, kp, vp)
        return self.out_proj(o.transpose(1, 2).reshape(b, -1, self.dim))


class MemoryAttentionLayer(nn.Module):
    def __init__(self, cfg: SAM2Config = SAM2Config()):
        super().__init__()
        d = cfg.d_model
        self.self_attn = RoPEAttention(d, cfg.memory_attn_heads)
        self.cross_attn_image = RoPEAttention(d, cfg.memory_attn_heads, kv_in_dim=cfg.mem_dim)
        self.norm1, self.norm2, self.norm3 = layer_norm(d), layer_norm(d), layer_norm(d)
        self.linear1 = nn.Linear(d, 2048)
        self.linear2 = nn.Linear(2048, d)

    def forward(self, x, memory, hw_q, hw_k, rope_k_rows):
        h = self.norm1(x)
        x = x + self.self_attn(h, h, h, hw_q, hw_q)
        h = self.norm2(x)
        x = x + self.cross_attn_image(h, memory, memory, hw_q, hw_k, rope_k_rows=rope_k_rows)
        return x + self.linear2(F.relu(self.linear1(self.norm3(x))))


class MemoryAttention(nn.Module):
    def __init__(self, cfg: SAM2Config = SAM2Config()):
        super().__init__()
        self.layers = nn.ModuleList(MemoryAttentionLayer(cfg)
                                    for _ in range(cfg.memory_attn_layers))
        self.norm = layer_norm(cfg.d_model)

    def forward(self, curr, memory, hw_q, hw_k, rope_k_rows):
        x = curr
        for layer in self.layers:
            x = layer(x, memory, hw_q, hw_k, rope_k_rows)
        return self.norm(x)

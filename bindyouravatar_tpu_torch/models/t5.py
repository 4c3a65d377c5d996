"""T5-v1.1 encoder in torch (port of `bindyouravatar_tpu/models/t5.py`).

The reference's text encoder (T5-XXL through transformers, 226-token
prompts, 4096-d output): RMSNorm (no mean, no bias), bidirectional relative
position buckets (32 buckets, 128 max distance, one bias table from layer 0
shared by every layer), attention without 1/sqrt(d), the gated-GELU FFN, a
final RMSNorm.  Attention is this module's own matrix products with the
bucket bias added to the fp32 scores and masked keys, as in JAX: the port's
`ops/attention.sdpa` takes no bias.  Parameter names follow the flax tree
(`block_{i}.attn.q`, `ln_ff`, `wi_0`, ...), so `convert.jax_params_to_torch`
maps them one to one; `token_embedding` [V, D] and `relative_attention_bias`
[buckets, H] are raw params in the JAX orientation.  `load_t5_encoder` reads
an HF `T5EncoderModel` file (the port's copy of the JAX package's
`training/import_encoders.py:import_t5_encoder`).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import T5Config
from .layers import Dense, init_random_


class RMSNorm(nn.Module):
    """x * rsqrt(mean(x^2) + eps) * weight, fp32 math, output in x's dtype."""

    def __init__(self, dim: int, eps: float = 1e-6, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        y = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + self.eps)
        return (y * self.weight.float()).to(x.dtype)


def relative_position_bucket(rel_pos: np.ndarray, num_buckets: int = 32,
                             max_distance: int = 128) -> np.ndarray:
    """Bidirectional T5 bucket function (host-side, static sequence length)."""
    num_buckets //= 2
    ret = (rel_pos > 0).astype(np.int64) * num_buckets
    n = np.abs(rel_pos)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_large = max_exact + (
        np.log(n.clip(1) / max_exact) / np.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).astype(np.int64)
    val_large = np.minimum(val_large, num_buckets - 1)
    return ret + np.where(is_small, n, val_large)


class T5SelfAttention(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        c = self.cfg = cfg
        inner = c.num_heads * c.d_kv
        kw = dict(bias=False, compute_dtype=c.dtype, dtype=c.param_dtype)
        self.q = Dense(c.d_model, inner, **kw)
        self.k = Dense(c.d_model, inner, **kw)
        self.v = Dense(c.d_model, inner, **kw)
        self.o = Dense(inner, c.d_model, **kw)

    def forward(self, x: torch.Tensor, bias: torch.Tensor,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
        c = self.cfg
        b, s, _ = x.shape
        heads = lambda t: t.reshape(b, s, c.num_heads, c.d_kv).transpose(1, 2)
        q, k, v = heads(self.q(x)), heads(self.k(x)), heads(self.v(x))
        # T5: no 1/sqrt(d) scaling
        sc = torch.matmul(q.float(), k.float().transpose(-1, -2)) + bias
        if mask is not None:
            sc = sc.masked_fill(~mask[:, None, None, :], torch.finfo(torch.float32).min)
        p = torch.softmax(sc, dim=-1).to(v.dtype)
        o = torch.matmul(p, v).transpose(1, 2).reshape(b, s, -1)
        return self.o(o)


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        c = cfg
        kw = dict(bias=False, compute_dtype=c.dtype, dtype=c.param_dtype)
        self.ln_attn = RMSNorm(c.d_model, c.layer_norm_epsilon, c.param_dtype)
        self.attn = T5SelfAttention(c)
        self.ln_ff = RMSNorm(c.d_model, c.layer_norm_epsilon, c.param_dtype)
        self.wi_0 = Dense(c.d_model, c.d_ff, **kw)
        self.wi_1 = Dense(c.d_model, c.d_ff, **kw)
        self.wo = Dense(c.d_ff, c.d_model, **kw)

    def forward(self, x, bias, mask):
        x = x + self.attn(self.ln_attn(x), bias, mask)
        h = self.ln_ff(x)
        h = F.gelu(self.wi_0(h), approximate="tanh") * self.wi_1(h)
        return x + self.wo(h)


class T5Encoder(nn.Module):
    """input_ids [B, S] (and a bool attention_mask [B, S]) -> embeddings
    [B, S, d_model] in `cfg.dtype`."""

    def __init__(self, cfg: T5Config = T5Config()):
        super().__init__()
        c = self.cfg = cfg
        self.token_embedding = nn.Parameter(torch.empty(c.vocab_size, c.d_model,
                                                        dtype=c.param_dtype))
        self.relative_attention_bias = nn.Parameter(
            torch.empty(c.relative_attention_num_buckets, c.num_heads, dtype=c.param_dtype))
        for i in range(c.num_layers):
            self.add_module(f"block_{i}", T5Block(c))
        self.final_ln = RMSNorm(c.d_model, c.layer_norm_epsilon, c.param_dtype)

    @classmethod
    def create(cls, cfg: T5Config = T5Config(), device: torch.device | str = "cuda",
               generator: Optional[torch.Generator] = None) -> "T5Encoder":
        """Build on `device` (the card unless the caller asks for another);
        with a `generator` the weights are drawn from it (`init_random_`, q
        further scaled by d_kv^-1/2 as T5's own init, the RMSNorm gains ~
        N(1, 0.1), the two tables ~ N(0, 1) as the flax init), else left
        for `load_state_dict`."""
        with torch.device("meta"):
            model = cls(cfg)
        model = model.to_empty(device=device)
        if generator is not None:
            with torch.no_grad():
                init_random_(model, generator)
                for m in model.modules():
                    if isinstance(m, RMSNorm):
                        m.weight.normal_(1.0, 0.1, generator=generator)
                    elif isinstance(m, T5SelfAttention):
                        m.q.weight.mul_(cfg.d_kv ** -0.5)
                model.token_embedding.normal_(0.0, 1.0, generator=generator)
                model.relative_attention_bias.normal_(0.0, 1.0, generator=generator)
        return model.eval()

    def position_bias(self, s: int) -> torch.Tensor:
        """[1, H, S, S] fp32 bucket bias (memory position minus query)."""
        c = self.cfg
        rel = np.arange(s)[None, :] - np.arange(s)[:, None]
        buckets = relative_position_bucket(rel, c.relative_attention_num_buckets,
                                           c.relative_attention_max_distance)
        idx = torch.from_numpy(buckets).to(self.relative_attention_bias.device)
        return self.relative_attention_bias[idx].permute(2, 0, 1)[None].float()

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        c = self.cfg
        x = self.token_embedding[input_ids].to(c.dtype)
        bias = self.position_bias(input_ids.shape[1])
        for i in range(c.num_layers):
            x = getattr(self, f"block_{i}")(x, bias, attention_mask)
        return self.final_ln(x)


def tokenize(prompts: Sequence[str], tokenizer_dir: str, max_length: int = 226):
    """Tokenize with a LOCAL tokenizer (the reference's T5 tokenizer at 226
    tokens): (input_ids [B, L] int64, attention_mask [B, L] bool), numpy."""
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(tokenizer_dir)
    out = tok(list(prompts), padding="max_length", max_length=max_length, truncation=True,
              return_tensors="np")
    return out["input_ids"].astype(np.int64), out["attention_mask"].astype(bool)


@torch.no_grad()
def encode_prompts(model: T5Encoder, prompts: Sequence[str], tokenizer_dir: str,
                   max_length: int = 226) -> torch.Tensor:
    """prompts -> embeddings [B, L, d_model] on the model's device.  Every
    row of the L is returned: padded positions pass through with the mask
    applied in attention, and the DiT consumes all 226."""
    ids, mask = tokenize(prompts, tokenizer_dir, max_length)
    dev = model.token_embedding.device
    return model(torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev))


def _load_file(path: str) -> Dict[str, torch.Tensor]:
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        return load_file(path)
    return torch.load(path, map_location="cpu", weights_only=True)


def t5_weights_file(t5_dir: str) -> str:
    """The weights file of an HF T5 directory."""
    for name in ("model.safetensors", "pytorch_model.bin"):
        path = os.path.join(t5_dir, name)
        if os.path.isfile(path):
            return path
    raise FileNotFoundError(f"no T5 weights (model.safetensors, pytorch_model.bin) under "
                            f"{t5_dir}")


def t5_state_dict(sd: Dict[str, torch.Tensor], cfg: T5Config) -> Dict[str, torch.Tensor]:
    """An HF `T5EncoderModel` state dict -> the port's names, fp32 (JAX's
    `import_t5_encoder` followed by `convert.jax_params_to_torch`)."""
    pre = "encoder." if any(k.startswith("encoder.") for k in sd) else ""
    shared = "shared.weight" if "shared.weight" in sd else f"{pre}embed_tokens.weight"
    g = lambda k: sd[k].float()
    out = {"token_embedding": g(shared),
           "relative_attention_bias": g(
               f"{pre}block.0.layer.0.SelfAttention.relative_attention_bias.weight"),
           "final_ln.weight": g(f"{pre}final_layer_norm.weight")}
    for i in range(cfg.num_layers):
        b, p = f"{pre}block.{i}.layer", f"block_{i}"
        out[f"{p}.ln_attn.weight"] = g(f"{b}.0.layer_norm.weight")
        for n in ("q", "k", "v", "o"):
            out[f"{p}.attn.{n}.weight"] = g(f"{b}.0.SelfAttention.{n}.weight")
        out[f"{p}.ln_ff.weight"] = g(f"{b}.1.layer_norm.weight")
        for n in ("wi_0", "wi_1", "wo"):
            out[f"{p}.{n}.weight"] = g(f"{b}.1.DenseReluDense.{n}.weight")
    return out


def load_t5_encoder(t5_dir: str, device: torch.device | str = "cuda",
                    **cfg_overrides) -> T5Encoder:
    """The encoder of an HF T5 directory (`config.json` and
    `model.safetensors` or `pytorch_model.bin`) on `device`."""
    cfg = T5Config.from_dir(t5_dir, **cfg_overrides)
    model = T5Encoder.create(cfg, device=device)
    model.load_state_dict(t5_state_dict(_load_file(t5_weights_file(t5_dir)), cfg))
    return model

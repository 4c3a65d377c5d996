"""wav2vec2-base in torch: the audio encoder behind the reference's audio
embeddings (the model the JAX package's `preprocess/audio.py` loads with
`transformers.Wav2Vec2Model.from_pretrained`; the card's machine has no
`transformers`, so the port writes it, as it writes T5).

The base layout (facebook/wav2vec2-base-960h's `config.json`):
  * the feature encoder: 7 convolutions of 512 channels (kernels 10, 3, 3,
    3, 3, 2, 2; strides 5, 2, 2, 2, 2, 2, 2; no bias), GroupNorm with one
    group per channel after the first only, exact GELU after each;
  * the feature projection: LayerNorm(512), then a 512 -> 768 linear;
  * the positional convolution (kernel 128, 16 groups, weight norm over
    dim 2, padding 64 with the last step dropped, GELU), added to the
    projection's output, then LayerNorm;
  * 12 post-LN transformer layers (768 wide, 12 heads, FF 3072, GELU).
`Wav2Vec2.forward` returns the hidden states HF returns with
`output_hidden_states=True`: the normalised input of layer 0, then every
layer's output.  fp32 on the card runs with TF32 off, so it computes what
the CPU computes up to the order of the sums.

`load_wav2vec2(model_dir)` reads an HF directory: `config.json` and
`model.safetensors` (`utils/safetensors.py`) or `pytorch_model.bin` (torch,
`weights_only`).  It takes both weight-norm namings (`weight_g` /
`weight_v`, and `parametrizations.weight.original0` / `original1`), strips
the `wav2vec2.` prefix of a ForCTC checkpoint and ignores `lm_head.*` and
`masked_spec_embed`, as `from_pretrained` does; any other unknown or
missing key raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
from typing import Dict, List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class Wav2Vec2Config:
    """The fields of an HF `Wav2Vec2Config` the base layout reads
    (wav2vec2-base's values as defaults)."""
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    conv_dim: Tuple[int, ...] = (512,) * 7
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = False
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    layer_norm_eps: float = 1e-5
    feat_extract_norm: str = "group"
    do_stable_layer_norm: bool = False
    hidden_act: str = "gelu"
    feat_extract_activation: str = "gelu"

    @classmethod
    def from_dir(cls, path: str) -> "Wav2Vec2Config":
        """An HF directory's `config.json`; raises on a layout other than
        the base one (the post-LN encoder with a group-normed first conv)."""
        with open(os.path.join(path, "config.json")) as f:
            hf = json.load(f)
        kw = {}
        for field in dataclasses.fields(cls):
            if field.name in hf:
                v = hf[field.name]
                kw[field.name] = tuple(v) if isinstance(v, list) else v
        cfg = cls(**kw)
        if (cfg.feat_extract_norm != "group" or cfg.do_stable_layer_norm
                or cfg.hidden_act != "gelu" or cfg.feat_extract_activation != "gelu"
                or hf.get("add_adapter")):
            raise ValueError(f"{path}: the port reads the wav2vec2-base layout (group-normed "
                             "feature encoder, post-LN encoder, GELU, no adapter)")
        return cfg


class _ConvLayer(nn.Module):
    def __init__(self, c_in: int, c_out: int, k: int, stride: int, bias: bool, norm: bool):
        super().__init__()
        self.conv = nn.Conv1d(c_in, c_out, k, stride=stride, bias=bias)
        self.layer_norm = nn.GroupNorm(c_out, c_out, affine=True) if norm else None

    def forward(self, x):
        x = self.conv(x)
        if self.layer_norm is not None:
            x = self.layer_norm(x)
        return F.gelu(x)


class _FeatureEncoder(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        dims = (1,) + tuple(cfg.conv_dim)
        self.conv_layers = nn.ModuleList([
            _ConvLayer(dims[i], dims[i + 1], cfg.conv_kernel[i], cfg.conv_stride[i],
                       cfg.conv_bias, norm=i == 0) for i in range(len(cfg.conv_dim))])

    def forward(self, wav):
        x = wav[:, None]
        for layer in self.conv_layers:
            x = layer(x)
        return x


class _FeatureProjection(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.layer_norm = nn.LayerNorm(cfg.conv_dim[-1], eps=cfg.layer_norm_eps)
        self.projection = nn.Linear(cfg.conv_dim[-1], cfg.hidden_size)

    def forward(self, x):
        return self.projection(self.layer_norm(x))


class _PosConv(nn.Module):
    """The positional convolution, its weight-normed kernel held folded
    (`load_wav2vec2` computes it from the checkpoint's g and v)."""

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        k = cfg.num_conv_pos_embeddings
        self.conv = nn.Conv1d(cfg.hidden_size, cfg.hidden_size, k, padding=k // 2,
                              groups=cfg.num_conv_pos_embedding_groups)
        self.drop_last = k % 2 == 0

    def forward(self, h):
        x = self.conv(h.transpose(1, 2))
        if self.drop_last:
            x = x[:, :, :-1]
        return F.gelu(x).transpose(1, 2)


class _Attention(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        d = cfg.hidden_size
        self.heads = cfg.num_attention_heads
        self.q_proj, self.k_proj = nn.Linear(d, d), nn.Linear(d, d)
        self.v_proj, self.out_proj = nn.Linear(d, d), nn.Linear(d, d)

    def forward(self, h):
        b, t, d = h.shape
        split = lambda x: x.reshape(b, t, self.heads, d // self.heads).transpose(1, 2)
        q, k, v = split(self.q_proj(h)), split(self.k_proj(h)), split(self.v_proj(h))
        s = torch.matmul(q, k.transpose(-1, -2)) * (d // self.heads) ** -0.5
        o = torch.matmul(torch.softmax(s, dim=-1), v)
        return self.out_proj(o.transpose(1, 2).reshape(b, t, d))


class _FeedForward(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.intermediate_dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.output_dense = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, h):
        return self.output_dense(F.gelu(self.intermediate_dense(h)))


class _EncoderLayer(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.attention = _Attention(cfg)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.feed_forward = _FeedForward(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, h):
        h = self.layer_norm(h + self.attention(h))
        return self.final_layer_norm(h + self.feed_forward(h))


class _Encoder(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.pos_conv_embed = _PosConv(cfg)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList([_EncoderLayer(cfg) for _ in range(cfg.num_hidden_layers)])


class Wav2Vec2(nn.Module):
    """wav2vec2-base's encoder under HF's parameter names
    (`feature_extractor.conv_layers.{i}`, `feature_projection`,
    `encoder.pos_conv_embed.conv` with the folded kernel as `weight`,
    `encoder.layers.{i}`)."""

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.cfg = cfg
        self.feature_extractor = _FeatureEncoder(cfg)
        self.feature_projection = _FeatureProjection(cfg)
        self.encoder = _Encoder(cfg)

    def forward(self, wav: torch.Tensor) -> List[torch.Tensor]:
        """wav [B, N] (raw, 16 kHz) -> the 1 + num_hidden_layers hidden
        states, each [B, T, hidden], T ~ N / 320."""
        with _no_tf32():
            h = self.feature_projection(self.feature_extractor(wav).transpose(1, 2))
            h = self.encoder.layer_norm(h + self.encoder.pos_conv_embed(h))
            states = [h]
            for layer in self.encoder.layers:
                h = layer(h)
                states.append(h)
        return states


@contextlib.contextmanager
def _no_tf32():
    """fp32 convolutions and matrix products at fp32 on the card (cuDNN's
    default is TF32)."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


_POS = "encoder.pos_conv_embed.conv."
_WEIGHT_NORM = {"weight_g": "g", "weight_v": "v", "parametrizations.weight.original0": "g",
                "parametrizations.weight.original1": "v"}


def wav2vec2_state_dict(raw: Dict[str, torch.Tensor], cfg: Wav2Vec2Config
                        ) -> Dict[str, torch.Tensor]:
    """An HF checkpoint's tensors -> the port's state dict: the `wav2vec2.`
    prefix stripped, `lm_head.*` and `masked_spec_embed` dropped, the
    positional kernel folded from its weight-norm g and v (over dim 2)."""
    out, norm = {}, {}
    for k, v in raw.items():
        k = k[len("wav2vec2."):] if k.startswith("wav2vec2.") else k
        if k.startswith("lm_head.") or k == "masked_spec_embed":
            continue
        if k.startswith(_POS) and k[len(_POS):] in _WEIGHT_NORM:
            norm[_WEIGHT_NORM[k[len(_POS):]]] = v.float()
            continue
        out[k] = v
    if set(norm) != {"g", "v"}:
        raise ValueError(f"the positional convolution's weight norm: have {sorted(norm)}, "
                         "need g and v")
    out[_POS + "weight"] = torch._weight_norm(norm["v"], norm["g"], 2)
    return out


def load_wav2vec2(model_dir: str, device: torch.device | str = "cuda",
                  dtype: torch.dtype = torch.float32) -> Wav2Vec2:
    """The wav2vec2 model of an HF directory (see the module note), on
    `device` in `dtype`, in eval mode."""
    cfg = Wav2Vec2Config.from_dir(model_dir)
    st = os.path.join(model_dir, "model.safetensors")
    if os.path.isfile(st):
        from ..utils.safetensors import load_file

        raw = load_file(st)
    else:
        raw = torch.load(os.path.join(model_dir, "pytorch_model.bin"), map_location="cpu",
                         weights_only=True)
    sd = wav2vec2_state_dict(raw, cfg)
    with torch.device("meta"):
        model = Wav2Vec2(cfg)
    want = set(model.state_dict())
    if set(sd) != want:
        raise ValueError(f"{model_dir}: missing {sorted(want - set(sd))[:5]}, unexpected "
                         f"{sorted(set(sd) - want)[:5]}")
    model = model.to_empty(device=device)
    with torch.no_grad():
        for name, p in model.state_dict().items():
            p.copy_(sd[name].to(device=device, dtype=torch.float32))
    return model.to(dtype).eval()


def resample_frames(hidden: torch.Tensor, num_frames: int) -> torch.Tensor:
    """[T50, ...] -> [num_frames, ...]: linear interpolation at
    `linspace(0, T50 - 1, num_frames)` (JAX `preprocess/audio.py:77-84`),
    the weights in float64 as numpy computes them."""
    import numpy as np

    t50 = hidden.shape[0]
    idx = np.linspace(0, t50 - 1, num_frames)
    lo = np.floor(idx).astype(np.int64)
    hi = np.minimum(lo + 1, t50 - 1)
    frac = torch.from_numpy(idx - lo).to(hidden.device)
    frac = frac.reshape((-1,) + (1,) * (hidden.ndim - 1))
    lo_t, hi_t = (torch.from_numpy(i).to(hidden.device) for i in (lo, hi))
    h = hidden.double()
    return ((1 - frac) * h[lo_t] + frac * h[hi_t]).float()


def extract(model: Wav2Vec2, wav: torch.Tensor, num_frames: int) -> torch.Tensor:
    """A mono 16 kHz wav [N] -> [num_frames, layers, hidden] fp32: the
    layers' hidden states (not the input's) stacked, resampled to the video
    frames."""
    with torch.no_grad():
        states = model(wav[None].to(next(model.parameters()).dtype))
        hs = torch.stack(states[1:], dim=2)[0].float()
    return resample_frames(hs, num_frames)

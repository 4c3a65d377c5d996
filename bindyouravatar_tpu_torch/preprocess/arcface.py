"""ArcFace identity embedder: IResNet-100 in torch (port of
`bindyouravatar_tpu/preprocess/arcface.py`), and the eval-mode batch norm
and PReLU the face stack's networks share.

IR-100 (insightface iresnet100): a 3x3 stem (64) + PReLU, 4 stages of
improved residual units [3, 13, 30, 3] over [64, 128, 256, 512] channels,
each BN-Conv3x3-BN-PReLU-Conv3x3(stride 2 in a stage's first unit)-BN plus
its shortcut, then BN, the NCHW flatten, FC(512) and BN1d.  Input 112 x 112
RGB in [-1, 1], output the 512-d embedding that is `id_cond`'s first half.

The modules carry the reference checkpoint's parameter names and layouts
(`layer1.0.bn1.running_mean`, `prelu.weight`, `downsample.0.weight`, the
fc over the NCHW flatten), so a reference file loads with
`load_state_dict(strict=True)` once `module.` prefixes and
`num_batches_tracked` are dropped (`reference_state_dict`).  The networks
compute in the dtype of their weights.  `HashEmbedder` is the JAX
package's deterministic stand-in when no checkpoint is given, a numpy/cv2
copy that equals it bit for bit.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

IR100_LAYERS = (3, 13, 30, 3)
IR100_CHANNELS = (64, 128, 256, 512)


class BN(nn.Module):
    """Inference-mode batch norm over dim 1 with the running statistics
    (the face nets are used frozen): (x - mean) * (rsqrt(var + eps) * weight)
    + bias, as JAX computes it.  torch `BatchNorm` names, without
    `num_batches_tracked`."""

    eps = 1e-5

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (-1,) + (1,) * (x.ndim - 2)
        inv = torch.rsqrt(self.running_var.float() + self.eps) * self.weight.float()
        return ((x - self.running_mean.to(x.dtype).view(shape)) * inv.to(x.dtype).view(shape)
                + self.bias.to(x.dtype).view(shape))


class PReLU(nn.Module):
    """x where x >= 0, else weight * x, one slope a channel (dim 1)."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.full((channels,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.weight.to(x.dtype).view((-1,) + (1,) * (x.ndim - 2))
        return torch.where(x >= 0, x, a * x)


def conv(cin: int, cout: int, ks: int, stride: int = 1) -> nn.Conv2d:
    """A square convolution without bias, padded by ks // 2 (JAX's
    `padding=ks // 2`)."""
    return nn.Conv2d(cin, cout, ks, stride, ks // 2, bias=False)


class IRBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.bn1 = BN(cin)
        self.conv1 = conv(cin, cout, 3)
        self.bn2 = BN(cout)
        self.prelu = PReLU(cout)
        self.conv2 = conv(cout, cout, 3, stride)
        self.bn3 = BN(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(conv(cin, cout, 1, stride), BN(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.bn3(self.conv2(self.prelu(self.bn2(self.conv1(self.bn1(x))))))
        return (x if self.downsample is None else self.downsample(x)) + h


class IResNet100(nn.Module):
    """images [B, 3, 112, 112] in [-1, 1] -> embeddings [B, 512]."""

    def __init__(self):
        super().__init__()
        self.conv1 = conv(3, 64, 3)
        self.bn1 = BN(64)
        self.prelu = PReLU(64)
        cin = 64
        for si, (n, ch) in enumerate(zip(IR100_LAYERS, IR100_CHANNELS)):
            self.add_module(f"layer{si + 1}", nn.Sequential(
                *[IRBlock(cin if bi == 0 else ch, ch, 2 if bi == 0 else 1) for bi in range(n)]))
            cin = ch
        self.bn2 = BN(512)
        self.fc = nn.Linear(512 * 7 * 7, 512)
        self.features = BN(512)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = self.prelu(self.bn1(self.conv1(images.to(self.conv1.weight.dtype))))
        for si in range(4):
            x = getattr(self, f"layer{si + 1}")(x)
        return self.features(self.fc(self.bn2(x).flatten(1)))


@torch.no_grad()
def draw_cnn_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights for a face-stack network from `generator`, on its
    device: conv and linear weights ~ N(0, 1/fan_in), their biases ~
    N(0, 0.02); BN gains ~ N(1, 0.1), shifts ~ N(0, 0.02), running means ~
    N(0, 0.1) and variances ~ U(0.5, 1.5); PReLU slopes 0.25."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            m.weight.normal_(0.0, m.weight[0].numel() ** -0.5, generator=generator)
            if m.bias is not None:
                m.bias.normal_(0.0, 0.02, generator=generator)
        elif isinstance(m, BN):
            m.weight.normal_(1.0, 0.1, generator=generator)
            m.bias.normal_(0.0, 0.02, generator=generator)
            m.running_mean.normal_(0.0, 0.1, generator=generator)
            m.running_var.uniform_(0.5, 1.5, generator=generator)
        elif isinstance(m, PReLU):
            m.weight.fill_(0.25)
    return module


def build(cls, device: torch.device | str = "cuda",
          generator: Optional[torch.Generator] = None) -> nn.Module:
    """A face-stack network on `device` (the card unless the caller asks for
    another), in eval mode; drawn from `generator` (`draw_cnn_`) when one is
    given, else left for `load_state_dict`."""
    with torch.device("meta"):
        model = cls()
    model = model.to_empty(device=device).eval()
    return draw_cnn_(model, generator) if generator is not None else model


def reference_state_dict(sd_or_path, drop: Sequence[str] = ()) -> Dict[str, torch.Tensor]:
    """A reference checkpoint (a torch file or its state dict, optionally
    under "state_dict") with `module.` prefixes, `num_batches_tracked` and
    the keys under the `drop` prefixes removed."""
    sd = sd_or_path
    if isinstance(sd, str):
        sd = torch.load(sd, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    sd = {k.replace("module.", ""): torch.as_tensor(v) for k, v in sd.items()}
    return {k: v for k, v in sd.items()
            if "num_batches" not in k and not any(k.startswith(p) for p in drop)}


def load_reference(cls, sd_or_path, device: torch.device | str = "cuda",
                   drop: Sequence[str] = ()) -> nn.Module:
    """A face-stack network from a reference checkpoint, loaded strictly."""
    model = build(cls, device)
    model.load_state_dict(reference_state_dict(sd_or_path, drop), strict=True)
    return model


class ArcFaceEmbedder:
    """The 512-d identity embedding of an `IResNet100`: images [B, 3, 112,
    112] in [-1, 1] (numpy) -> [B, 512] float32 numpy."""

    def __init__(self, model: IResNet100):
        self.model = model

    @classmethod
    def from_checkpoint(cls, sd_or_path, device: torch.device | str = "cuda"):
        """insightface arcface_torch's `iresnet100` checkpoint."""
        return cls(load_reference(IResNet100, sd_or_path, device))

    @torch.no_grad()
    def __call__(self, images: np.ndarray) -> np.ndarray:
        dev = self.model.conv1.weight.device
        x = torch.from_numpy(np.asarray(images, np.float32)).to(dev)
        return self.model(x).float().cpu().numpy()


class HashEmbedder:
    """Deterministic fallback identity embedder (no weights available): a
    fixed random projection of 16 x 16 downsampled pixels.  Stable across
    runs so ids are consistent; NOT identity-discriminative like ArcFace:
    it keeps the pipeline runnable where no checkpoint is given."""

    def __init__(self, dim: int = 512, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.proj = rng.normal(0, 1.0 / 16, (3 * 16 * 16, dim)).astype(np.float32)

    def __call__(self, images: np.ndarray) -> np.ndarray:
        import cv2

        out = []
        for img in images:
            small = cv2.resize(img.transpose(1, 2, 0), (16, 16)).reshape(-1)
            v = small @ self.proj
            out.append(v / (np.linalg.norm(v) + 1e-6))
        return np.stack(out)

"""RRDBNet x4 (the Real-ESRGAN / ESRGAN super-resolution backbone) in
torch: the port of `bindyouravatar_tpu/models/rrdbnet.py`.

conv_first -> `num_block` RRDBs (each 3 ResidualDenseBlocks of 5 growing
3x3 convs, LeakyReLU 0.2, residual scale 0.2) -> conv_body (+ skip) ->
nearest x2 -> conv_up1 -> nearest x2 -> conv_up2 -> conv_hr -> conv_last.
NCHW in and out, as the reference.  The modules carry Real-ESRGAN's names
(`conv_first`, `body.{i}.rdb{m}.conv{k}`, `conv_up1`, ...), so
`RealESRGAN_x4plus.pth` (its plain state dict or the `params_ema` /
`params` wrapper) loads strictly (`load_rrdbnet`).  The network computes in
the dtype of its weights.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


class ResidualDenseBlock(nn.Module):
    def __init__(self, feat: int = 64, grow: int = 32):
        super().__init__()
        for k in range(1, 6):
            cout = grow if k < 5 else feat
            setattr(self, f"conv{k}", nn.Conv2d(feat + (k - 1) * grow, cout, 3, padding=1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = [x]
        for k in range(1, 5):
            feats.append(_lrelu(getattr(self, f"conv{k}")(torch.cat(feats, 1))))
        return self.conv5(torch.cat(feats, 1)) * 0.2 + x


class RRDB(nn.Module):
    def __init__(self, feat: int = 64, grow: int = 32):
        super().__init__()
        self.rdb1 = ResidualDenseBlock(feat, grow)
        self.rdb2 = ResidualDenseBlock(feat, grow)
        self.rdb3 = ResidualDenseBlock(feat, grow)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.rdb3(self.rdb2(self.rdb1(x))) * 0.2 + x


def _nearest2x(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class RRDBNet(nn.Module):
    """x4 RRDBNet: [N, C, H, W] -> [N, out_ch, 4H, 4W]."""

    scale = 4

    def __init__(self, in_ch: int = 3, out_ch: int = 3, feat: int = 64, num_block: int = 23,
                 grow: int = 32):
        super().__init__()
        conv = lambda cin, cout: nn.Conv2d(cin, cout, 3, padding=1)
        self.conv_first = conv(in_ch, feat)
        self.body = nn.ModuleList(RRDB(feat, grow) for _ in range(num_block))
        self.conv_body = conv(feat, feat)
        self.conv_up1 = conv(feat, feat)
        self.conv_up2 = conv(feat, feat)
        self.conv_hr = conv(feat, feat)
        self.conv_last = conv(feat, out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feat = self.conv_first(x.to(self.conv_first.weight.dtype))
        body = feat
        for blk in self.body:
            body = blk(body)
        feat = feat + self.conv_body(body)
        feat = _lrelu(self.conv_up1(_nearest2x(feat)))
        feat = _lrelu(self.conv_up2(_nearest2x(feat)))
        return self.conv_last(_lrelu(self.conv_hr(feat)))


def build_rrdbnet(num_block: int = 23, device: torch.device | str = "cuda",
                  generator: Optional[torch.Generator] = None, **kw) -> RRDBNet:
    """An `RRDBNet` on `device` in eval mode; with a `generator`, conv
    kernels drawn ~ N(0, 1 / fan_in) x 0.1 in the residual blocks (the
    reference's init scale) and x 1 elsewhere, biases ~ N(0, 0.01)."""
    with torch.device("meta"):
        model = RRDBNet(num_block=num_block, **kw)
    model = model.to_empty(device=device).eval()
    if generator is not None:
        with torch.no_grad():
            for name, p in model.named_parameters():
                z = torch.randn(p.shape, generator=generator, device=p.device)
                if name.endswith("weight"):
                    z = z / p[0].numel() ** 0.5 * (0.1 if name.startswith("body.") else 1.0)
                else:
                    z = 0.01 * z
                p.copy_(z)
    return model


def load_rrdbnet(sd_or_path, num_block: int = 23, device: torch.device | str = "cuda",
                 **kw) -> RRDBNet:
    """An `RRDBNet` from a Real-ESRGAN checkpoint (a file or its state dict,
    plain or under `params_ema` / `params`), loaded with `strict=True`."""
    sd = sd_or_path
    if not isinstance(sd, dict):
        sd = torch.load(sd_or_path, map_location="cpu", weights_only=True)
    for wrap in ("params_ema", "params"):
        if wrap in sd:
            sd = sd[wrap]
            break
    model = build_rrdbnet(num_block, device, **kw)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()}, strict=True)
    return model

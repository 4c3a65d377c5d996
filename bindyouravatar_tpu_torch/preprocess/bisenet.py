"""BiSeNet face parsing (19 CelebAMask-HQ classes) in torch (port of
`bindyouravatar_tpu/preprocess/bisenet.py`).

The reference parses the aligned 512 x 512 face with facexlib's BiSeNet
and whites out the background labels before EVA-CLIP: a ResNet-18 context
path with two attention-refinement modules and a global-average shortcut,
the feature-fusion module, a 1x1 classifier head and a bilinear
(align-corners) upsample back to the input size.  The modules carry the
reference checkpoint's names (`cp.resnet.layer2.0.downsample.1.weight`,
`cp.arm16.conv_atten.weight`, `ffm.convblk.bn.running_mean`,
`conv_out.conv_out.weight`), so facexlib's `parsing_bisenet.pth` loads
strictly once its training-only auxiliary heads (`conv_out16`,
`conv_out32`) are dropped (`load_bisenet_parser`).  The upsamples index
and weigh as JAX's numpy tables do, not through `F.interpolate`.

Input contract: RGB in [0, 1], ImageNet-normalised, NCHW [B, 3, 512, 512];
output logits [B, 19, 512, 512].
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .arcface import BN, conv, load_reference
from .retinaface import upsample_nearest

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
NUM_CLASSES = 19
AUX_HEADS = ("conv_out16.", "conv_out32.")


def upsample_bilinear_ac(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """torch `F.interpolate(mode="bilinear", align_corners=True)` on NCHW
    with JAX's index and weight tables: rows then columns."""
    h, w = hw
    ih, iw = x.shape[2], x.shape[3]

    def axis_weights(out_n, in_n):
        if out_n == 1 or in_n == 1:
            z = np.zeros(out_n, np.int64)
            return z, z, np.zeros(out_n, np.float32)
        pos = np.arange(out_n) * (in_n - 1) / (out_n - 1)
        lo = np.clip(np.floor(pos).astype(np.int64), 0, in_n - 1)
        hi = np.clip(lo + 1, 0, in_n - 1)
        return lo, hi, (pos - lo).astype(np.float32)

    t = lambda a: torch.from_numpy(a).to(x.device)
    rlo, rhi, rw = (t(a) for a in axis_weights(h, ih))
    clo, chi, cw = (t(a) for a in axis_weights(w, iw))
    rw, cw = rw.to(x.dtype)[:, None], cw.to(x.dtype)
    top = x[:, :, rlo] * (1 - rw) + x[:, :, rhi] * rw
    return top[:, :, :, clo] * (1 - cw) + top[:, :, :, chi] * cw


class ConvBNReLU(nn.Module):
    def __init__(self, cin: int, cout: int, ks: int = 3, stride: int = 1):
        super().__init__()
        self.conv = conv(cin, cout, ks, stride)
        self.bn = BN(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = conv(cin, cout, 3, stride)
        self.bn1 = BN(cout)
        self.conv2 = conv(cout, cout, 3)
        self.bn2 = BN(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(conv(cin, cout, 1, stride), BN(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        return F.relu((x if self.downsample is None else self.downsample(x)) + h)


class ResNet18(nn.Module):
    """-> (feat8 [B, 128, H/8, W/8], feat16 [.., 256, ..], feat32 [.., 512, ..])."""

    def __init__(self):
        super().__init__()
        self.conv1 = conv(3, 64, 7, 2)
        self.bn1 = BN(64)
        cin = 64
        for si, ch in enumerate((64, 128, 256, 512)):
            stride = 2 if si > 0 else 1
            self.add_module(f"layer{si + 1}", nn.Sequential(BasicBlock(cin, ch, stride),
                                                            BasicBlock(ch, ch)))
            cin = ch

    def forward(self, x: torch.Tensor):
        x = self.layer1(F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1))
        feat8 = self.layer2(x)
        feat16 = self.layer3(feat8)
        return feat8, feat16, self.layer4(feat16)


class ARM(nn.Module):
    """Attention refinement: conv-bn-relu, then a global-pool sigmoid gate."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = ConvBNReLU(cin, cout, 3)
        self.conv_atten = conv(cout, cout, 1)
        self.bn_atten = BN(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feat = self.conv(x)
        atten = feat.mean(dim=(2, 3), keepdim=True)
        return feat * torch.sigmoid(self.bn_atten(self.conv_atten(atten)))


class ContextPath(nn.Module):
    def __init__(self):
        super().__init__()
        self.resnet = ResNet18()
        self.arm16 = ARM(256, 128)
        self.arm32 = ARM(512, 128)
        self.conv_head32 = ConvBNReLU(128, 128, 3)
        self.conv_head16 = ConvBNReLU(128, 128, 3)
        self.conv_avg = ConvBNReLU(512, 128, 1)

    def forward(self, x: torch.Tensor):
        feat8, feat16, feat32 = self.resnet(x)
        avg = self.conv_avg(feat32.mean(dim=(2, 3), keepdim=True))
        feat32_sum = self.arm32(feat32) + upsample_nearest(avg, feat32.shape[2:])
        feat32_up = self.conv_head32(upsample_nearest(feat32_sum, feat16.shape[2:]))
        feat16_sum = self.arm16(feat16) + feat32_up
        feat16_up = self.conv_head16(upsample_nearest(feat16_sum, feat8.shape[2:]))
        return feat8, feat16_up, feat32_up


class FFM(nn.Module):
    """Feature fusion: concat, 1x1 conv-bn-relu, an SE-style residual gate."""

    def __init__(self, cin: int = 256, cout: int = 256):
        super().__init__()
        self.convblk = ConvBNReLU(cin, cout, 1)
        self.conv1 = conv(cout, cout // 4, 1)
        self.conv2 = conv(cout // 4, cout, 1)

    def forward(self, fsp: torch.Tensor, fcp: torch.Tensor) -> torch.Tensor:
        feat = self.convblk(torch.cat([fsp, fcp], dim=1))
        atten = feat.mean(dim=(2, 3), keepdim=True)
        atten = torch.sigmoid(self.conv2(F.relu(self.conv1(atten))))
        return feat * atten + feat


class BiSeNetOutput(nn.Module):
    def __init__(self, cin: int, mid: int, n_classes: int = NUM_CLASSES):
        super().__init__()
        self.conv = ConvBNReLU(cin, mid, 3)
        self.conv_out = conv(mid, n_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_out(self.conv(x))


class BiSeNet(nn.Module):
    """NCHW [B, 3, H, W] ImageNet-normalised RGB -> logits [B, 19, H, W] in
    the dtype of the weights (the main head; the auxiliary heads exist only
    for training)."""

    def __init__(self):
        super().__init__()
        self.cp = ContextPath()
        self.ffm = FFM()
        self.conv_out = BiSeNetOutput(256, 256)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.to(self.cp.resnet.conv1.weight.dtype)
        feat_sp, feat_cp8, _ = self.cp(x)
        out = self.conv_out(self.ffm(feat_sp, feat_cp8))
        return upsample_bilinear_ac(out, x.shape[2:])


class BiSeNetParser:
    """`face_parser` backend of `FaceProcessor`: RGB [512, 512, 3] uint8 ->
    labels [512, 512] (the argmax of the 19 logits); /255 and ImageNet
    normalisation as the reference does."""

    def __init__(self, model: BiSeNet):
        self.model = model

    @torch.no_grad()
    def __call__(self, face: np.ndarray) -> np.ndarray:
        x = face.astype(np.float32) / 255.0
        x = (x - np.asarray(IMAGENET_MEAN, np.float32)) / np.asarray(IMAGENET_STD, np.float32)
        x = torch.from_numpy(x.transpose(2, 0, 1)[None].copy())
        logits = self.model(x.to(self.model.cp.resnet.conv1.weight.device))
        return logits.argmax(dim=1)[0].cpu().numpy()


def load_bisenet_parser(checkpoint_path: str,
                        device: torch.device | str = "cuda") -> BiSeNetParser:
    """A parser on facexlib's `parsing_bisenet.pth`, the network loaded
    strictly on `device` without the auxiliary heads."""
    return BiSeNetParser(load_reference(BiSeNet, checkpoint_path, device, drop=AUX_HEADS))

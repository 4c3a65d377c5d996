"""RetinaFace (ResNet-50) face detector in torch (port of
`bindyouravatar_tpu/preprocess/retinaface.py`).

The reference detects faces and their 5-point landmarks with facexlib's
RetinaFace (the biubug6 Pytorch_Retinaface ResNet-50 variant): torchvision
ResNet-50 C3/C4/C5 taps, a 3-level FPN, SSH context modules and 2-anchor
class / box / landmark heads.  Anchors, decoding and NMS run on the host in
numpy (copies of JAX's).  The modules carry the reference checkpoint's
names (`body.layer1.0.conv1.weight`, `fpn.output1.0.weight`,
`ssh1.conv3X3.1.running_var`, `BboxHead.0.conv1x1.bias`), so facexlib's
`detection_Resnet50_Final.pth` loads strictly
(`load_retinaface_detector`).

Input contract (the original's): BGR float32 minus (104, 117, 123), NCHW.
The network is fully convolutional; `RetinaFaceDetector` pads an image to
a multiple of 32 so the conv and anchor grids agree.
"""

from __future__ import annotations

import functools
import itertools
import math
from typing import List

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .arcface import BN, conv, load_reference

VARIANCES = (0.1, 0.2)
MIN_SIZES = ((16, 32), (64, 128), (256, 512))
STEPS = (8, 16, 32)
NUM_ANCHORS = 2
MEAN_BGR = (104.0, 117.0, 123.0)
RESNET50_BLOCKS = (3, 4, 6, 3)
RESNET50_WIDTHS = (64, 128, 256, 512)


class ConvBN(nn.Sequential):
    """Conv (no bias, padded by ks // 2) then BN, as `.0` / `.1`, then a
    ReLU unless `relu=False` (the reference's LeakyReLU at slope 0)."""

    def __init__(self, cin: int, cout: int, ks: int = 3, stride: int = 1, relu: bool = True):
        super().__init__(conv(cin, cout, ks, stride), BN(cout))
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = super().forward(x)
        return F.relu(x) if self.relu else x


class Bottleneck(nn.Module):
    def __init__(self, cin: int, width: int, stride: int = 1):
        super().__init__()
        out = width * 4
        self.conv1 = conv(cin, width, 1)
        self.bn1 = BN(width)
        self.conv2 = conv(width, width, 3, stride)
        self.bn2 = BN(width)
        self.conv3 = conv(width, out, 1)
        self.bn3 = BN(out)
        self.downsample = None
        if stride != 1 or cin != out:
            self.downsample = nn.Sequential(conv(cin, out, 1, stride), BN(out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        return F.relu((x if self.downsample is None else self.downsample(x)) + h)


class ResNet50C345(nn.Module):
    """torchvision ResNet-50 trunk -> (C3 [/8, 512], C4 [/16, 1024], C5
    [/32, 2048])."""

    def __init__(self):
        super().__init__()
        self.conv1 = conv(3, 64, 7, 2)
        self.bn1 = BN(64)
        cin = 64
        for si, (n, w) in enumerate(zip(RESNET50_BLOCKS, RESNET50_WIDTHS)):
            self.add_module(f"layer{si + 1}", nn.Sequential(*[
                Bottleneck(cin if bi == 0 else w * 4, w, 2 if (bi == 0 and si > 0) else 1)
                for bi in range(n)]))
            cin = w * 4

    def forward(self, x: torch.Tensor):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        x = self.layer1(x)
        c3 = self.layer2(x)
        c4 = self.layer3(c3)
        return c3, c4, self.layer4(c4)


def upsample_nearest(x: torch.Tensor, hw) -> torch.Tensor:
    """torch `F.interpolate(mode="nearest")` on NCHW as JAX computes it:
    source index floor(i * in / out) in integers."""
    h, w = hw
    ih, iw = x.shape[2], x.shape[3]
    if (h, w) == (ih, iw):
        return x
    ri = torch.from_numpy(np.arange(h) * ih // h).to(x.device)
    ci = torch.from_numpy(np.arange(w) * iw // w).to(x.device)
    return x[:, :, ri][:, :, :, ci]


class FPN(nn.Module):
    def __init__(self, features: int = 256):
        super().__init__()
        self.output1 = ConvBN(512, features, 1)
        self.output2 = ConvBN(1024, features, 1)
        self.output3 = ConvBN(2048, features, 1)
        self.merge1 = ConvBN(features, features, 3)
        self.merge2 = ConvBN(features, features, 3)

    def forward(self, c3, c4, c5):
        out1, out2, out3 = self.output1(c3), self.output2(c4), self.output3(c5)
        out2 = self.merge2(out2 + upsample_nearest(out3, out2.shape[2:]))
        out1 = self.merge1(out1 + upsample_nearest(out2, out1.shape[2:]))
        return out1, out2, out3


class SSH(nn.Module):
    def __init__(self, features: int = 256):
        super().__init__()
        half, quarter = features // 2, features // 4
        self.conv3X3 = ConvBN(features, half, relu=False)
        self.conv5X5_1 = ConvBN(features, quarter)
        self.conv5X5_2 = ConvBN(quarter, quarter, relu=False)
        self.conv7X7_2 = ConvBN(quarter, quarter)
        self.conv7x7_3 = ConvBN(quarter, quarter, relu=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c5_1 = self.conv5X5_1(x)
        return F.relu(torch.cat([self.conv3X3(x), self.conv5X5_2(c5_1),
                                 self.conv7x7_3(self.conv7X7_2(c5_1))], dim=1))


class _Head(nn.Module):
    """One level's 1x1 head: [B, 256, H, W] -> [B, H * W * anchors, n]."""

    def __init__(self, n: int, features: int = 256):
        super().__init__()
        self.n = n
        self.conv1x1 = nn.Conv2d(features, NUM_ANCHORS * n, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv1x1(x).permute(0, 2, 3, 1).reshape(x.shape[0], -1, self.n)


class RetinaFace(nn.Module):
    """BGR mean-subtracted NCHW [B, 3, H, W] (H, W multiples of 32) ->
    (loc [B, A, 4], conf [B, A, 2] softmaxed, landm [B, A, 10]), A the
    anchors over the three strides; in the dtype of the weights."""

    def __init__(self):
        super().__init__()
        self.body = ResNet50C345()
        self.fpn = FPN()
        self.ssh1, self.ssh2, self.ssh3 = SSH(), SSH(), SSH()
        self.ClassHead = nn.ModuleList([_Head(2) for _ in range(3)])
        self.BboxHead = nn.ModuleList([_Head(4) for _ in range(3)])
        self.LandmarkHead = nn.ModuleList([_Head(10) for _ in range(3)])

    def forward(self, images: torch.Tensor):
        f1, f2, f3 = self.fpn(*self.body(images.to(self.body.conv1.weight.dtype)))
        feats = (self.ssh1(f1), self.ssh2(f2), self.ssh3(f3))
        cat = lambda heads: torch.cat([h(f) for h, f in zip(heads, feats)], dim=1)
        return cat(self.BboxHead), torch.softmax(cat(self.ClassHead), dim=-1), \
            cat(self.LandmarkHead)


# --------------------------------------------------------------------- #
# anchors, decode, NMS (host-side numpy, copies of JAX's)

@functools.lru_cache(maxsize=16)
def prior_boxes(h: int, w: int) -> np.ndarray:
    """[A, 4] (cx, cy, sx, sy) normalised anchors (biubug6 PriorBox)."""
    anchors = []
    for sizes, step in zip(MIN_SIZES, STEPS):
        fh, fw = math.ceil(h / step), math.ceil(w / step)
        for i, j in itertools.product(range(fh), range(fw)):
            for ms in sizes:
                anchors.append([(j + 0.5) * step / w, (i + 0.5) * step / h, ms / w, ms / h])
    return np.asarray(anchors, np.float32)


def decode_boxes(loc: np.ndarray, priors: np.ndarray) -> np.ndarray:
    """[A, 4] regression deltas -> [A, 4] (x0, y0, x1, y1) normalised corners."""
    cxy = priors[:, :2] + loc[:, :2] * VARIANCES[0] * priors[:, 2:]
    wh = priors[:, 2:] * np.exp(loc[:, 2:] * VARIANCES[1])
    return np.concatenate([cxy - wh / 2, cxy + wh / 2], axis=1)


def decode_landmarks(landm: np.ndarray, priors: np.ndarray) -> np.ndarray:
    """[A, 10] deltas -> [A, 5, 2] normalised landmark points."""
    pts = [priors[:, :2] + landm[:, 2 * i:2 * i + 2] * VARIANCES[0] * priors[:, 2:]
           for i in range(5)]
    return np.stack(pts, axis=1)


def nms(boxes: np.ndarray, scores: np.ndarray, thresh: float = 0.4) -> List[int]:
    x0, y0, x1, y1 = boxes.T
    areas = (x1 - x0) * (y1 - y0)
    order = scores.argsort()[::-1]
    keep = []
    while order.size:
        i = order[0]
        keep.append(int(i))
        xx0 = np.maximum(x0[i], x0[order[1:]])
        yy0 = np.maximum(y0[i], y0[order[1:]])
        xx1 = np.minimum(x1[i], x1[order[1:]])
        yy1 = np.minimum(y1[i], y1[order[1:]])
        inter = np.maximum(0, xx1 - xx0) * np.maximum(0, yy1 - yy0)
        iou = inter / (areas[i] + areas[order[1:]] - inter + 1e-9)
        order = order[1:][iou <= thresh]
    return keep


class RetinaFaceDetector:
    """`FaceDetector` backend: RGB uint8 [H, W, 3] -> a list of
    `DetectedFace` (bbox [4], landmarks [5, 2]) sorted left to right, the
    reference's detection contract."""

    def __init__(self, model: RetinaFace, conf_threshold: float = 0.8,
                 nms_threshold: float = 0.4):
        self.model, self.conf_threshold, self.nms_threshold = model, conf_threshold, nms_threshold

    @torch.no_grad()
    def __call__(self, image: np.ndarray):
        from .face import DetectedFace

        h, w = image.shape[:2]
        hp, wp = -(-h // 32) * 32, -(-w // 32) * 32
        bgr = image[..., ::-1].astype(np.float32) - np.asarray(MEAN_BGR)
        buf = np.zeros((hp, wp, 3), np.float32)
        buf[:h, :w] = bgr
        x = torch.from_numpy(buf.transpose(2, 0, 1)[None].copy())
        loc, conf, landm = (t[0].float().cpu().numpy() for t in
                            self.model(x.to(self.model.body.conv1.weight.device)))
        priors = prior_boxes(hp, wp)
        scores = conf[:, 1]
        sel = scores > self.conf_threshold
        if not sel.any():
            return []
        boxes = decode_boxes(loc[sel], priors[sel]) * np.asarray([wp, hp, wp, hp], np.float32)
        pts = decode_landmarks(landm[sel], priors[sel]) * np.asarray([wp, hp], np.float32)
        keep = nms(boxes, scores[sel], self.nms_threshold)
        out = [DetectedFace(bbox=np.clip(boxes[i], 0, [w, h, w, h]), landmarks=pts[i])
               for i in keep]
        return sorted(out, key=lambda d: d.bbox[0])


def load_retinaface_detector(checkpoint_path: str, device: torch.device | str = "cuda",
                             **kw) -> RetinaFaceDetector:
    """A detector on facexlib's `detection_Resnet50_Final.pth`, the network
    loaded strictly on `device`."""
    return RetinaFaceDetector(load_reference(RetinaFace, checkpoint_path, device), **kw)

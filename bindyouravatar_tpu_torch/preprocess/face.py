"""The face preprocessing stack (port of `bindyouravatar_tpu/preprocess/face.py`;
the reference's `models/utils.py:287-628`).

Per identity: detect -> 5-point align (the ArcFace 112 template and the 512
"restore" crop) -> [parse and white out the background] -> EVA-CLIP (pooled
768 + 5 hidden states) and ArcFace (512) -> `id_cond` = [arcface || clip
pooled] (1280) and `id_vit_hidden`, plus the side-by-side composite canvas
that conditions the clip when no background frame is given
(`process_split`).  The host-side numpy/cv2 helpers are copies of JAX's.

Each backend falls back when its checkpoint is not given, as in JAX: the
detector takes the full frame as the face (the repo's face images are
pre-cropped), the whiteout is skipped, ArcFace becomes `HashEmbedder`.
Without a tower the EVA-CLIP weights are drawn from a `torch.Generator`
seeded with `seed` on the device, where JAX draws from `jax.random.key(0)`:
the two stand-ins differ (a deliberate deviation; tests hold the port to
JAX on converted weights).  The networks run on `device`, the card unless
the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

# insightface's standard 5-point ArcFace destination template (112x112)
ARCFACE_DST = np.array(
    [[38.2946, 51.6963], [73.5318, 51.5014], [56.0252, 71.7366],
     [41.5493, 92.3655], [70.7299, 92.2041]], dtype=np.float32)


def resize_numpy_image_long(image: np.ndarray, long_side: int = 1024) -> np.ndarray:
    """Cap the long side (reference `models/utils.py:608-628`)."""
    import cv2

    h, w = image.shape[:2]
    if max(h, w) <= long_side:
        return image
    s = long_side / max(h, w)
    return cv2.resize(image, (int(round(w * s)), int(round(h * s))),
                      interpolation=cv2.INTER_AREA)


def estimate_norm(landmarks: np.ndarray, size: int = 112) -> np.ndarray:
    """Umeyama similarity transform from 5 landmarks to the ArcFace
    template (insightface `estimate_norm` semantics)."""
    src = landmarks.astype(np.float64)
    dst = (ARCFACE_DST * (size / 112.0)).astype(np.float64)
    mu_s, mu_d = src.mean(0), dst.mean(0)
    sc, dc = src - mu_s, dst - mu_d
    cov = dc.T @ sc / 5.0
    u, s, vt = np.linalg.svd(cov)
    d = np.sign(np.linalg.det(u) * np.linalg.det(vt))
    dd = np.diag([1.0, d])
    r = u @ dd @ vt
    var = (sc ** 2).sum() / 5.0
    scale = (s * np.diag(dd)).sum() / var
    t = mu_d - scale * (r @ mu_s)
    m = np.zeros((2, 3))
    m[:, :2] = scale * r
    m[:, 2] = t
    return m.astype(np.float32)


def warp_align(image: np.ndarray, landmarks: np.ndarray, size: int = 112) -> np.ndarray:
    import cv2

    m = estimate_norm(landmarks, size)
    return cv2.warpAffine(image, m, (size, size), borderValue=0.0)


@dataclasses.dataclass
class DetectedFace:
    bbox: np.ndarray                      # (x0, y0, x1, y1)
    landmarks: Optional[np.ndarray]       # (5, 2) or None


class FaceDetector:
    """Pluggable detection.  Backends:
      * 'retinaface': `preprocess/retinaface.py` on facexlib's
        `detection_Resnet50_Final.pth` (the reference's detector)
      * 'yunet': cv2.FaceDetectorYN when a model file is supplied
      * 'fullframe': the whole image is one face (pre-cropped images)
    """

    def __init__(self, backend: str = "auto", yunet_model: Optional[str] = None,
                 retinaface_checkpoint: Optional[str] = None,
                 device: torch.device | str = "cuda"):
        self.backend = backend
        self._yunet = None
        self._retina = None
        if retinaface_checkpoint:
            from .retinaface import load_retinaface_detector

            self._retina = load_retinaface_detector(retinaface_checkpoint, device)
            self.backend = "retinaface"
        elif yunet_model:
            import cv2

            self._yunet = cv2.FaceDetectorYN.create(yunet_model, "", (320, 320))
            self.backend = "yunet"
        elif backend == "auto":
            self.backend = "fullframe"

    def __call__(self, image: np.ndarray) -> List[DetectedFace]:
        h, w = image.shape[:2]
        if self.backend == "retinaface" and self._retina is not None:
            return self._retina(image)
        if self.backend == "yunet" and self._yunet is not None:
            import cv2

            self._yunet.setInputSize((w, h))
            _, faces = self._yunet.detect(cv2.cvtColor(image, cv2.COLOR_RGB2BGR))
            out = []
            if faces is not None:
                for f in faces:
                    x, y, bw, bh = f[:4]
                    out.append(DetectedFace(np.array([x, y, x + bw, y + bh]),
                                            f[4:14].reshape(5, 2)))
            return sorted(out, key=lambda d: d.bbox[0])   # left -> right
        return [DetectedFace(np.array([0, 0, w, h], np.float32), None)]


# bisenet background labels whited out before CLIP (reference
# `models/utils.py:475`): background, clothes, hat, ears, earrings, neck(s)
BISENET_BG_LABELS = (0, 16, 18, 7, 8, 9, 14, 15)


def parse_whiteout(face: np.ndarray, parsing: np.ndarray,
                   bg_labels: Sequence[int] = BISENET_BG_LABELS,
                   skip_bg_removal: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Face-parsing background whiteout (reference `models/utils.py:466-484`).

    face: RGB [H, W, 3] (uint8 or float 0..255); parsing: [H, W] int bisenet
    labels.  Returns float32 0..255 images:
      * clip_input: the parsed face on white, in GRAYSCALE (`to_gray`): what
        the EVA-CLIP tower sees;
      * composite: the background whited out, the face in colour (for the
        conditioning canvas), or the original when `skip_bg_removal`.
    """
    f = face.astype(np.float32)
    bg = np.isin(parsing, np.asarray(bg_labels))[..., None]
    luma = f @ np.asarray([0.299, 0.587, 0.114], np.float32)
    gray = np.repeat(luma[..., None], 3, axis=-1)
    white = np.full_like(f, 255.0)
    clip_input = np.where(bg, white, gray)
    composite = f if skip_bg_removal else np.where(bg, white, f)
    return clip_input, composite


@dataclasses.dataclass
class FaceProcessor:
    """End-to-end face conditioning (reference `process_face_embeddings*`)."""
    eva_apply: Callable[[np.ndarray], Tuple[np.ndarray, np.ndarray]]
    arcface: Callable[[np.ndarray], np.ndarray]
    detector: FaceDetector = dataclasses.field(default_factory=FaceDetector)
    # bisenet-semantics parser: face512 RGB -> [512, 512] int labels; None
    # skips the whiteout
    face_parser: Optional[Callable[[np.ndarray], np.ndarray]] = None
    skip_bg_removal: bool = False
    eva_size: int = 336
    # EVA-CLIP normalisation (OpenAI CLIP stats, as the vendored package)
    mean: Tuple[float, float, float] = (0.48145466, 0.4578275, 0.40821073)
    std: Tuple[float, float, float] = (0.26862954, 0.26130258, 0.27577711)

    def _eva_input(self, face: np.ndarray) -> np.ndarray:
        import cv2

        img = cv2.resize(face, (self.eva_size, self.eva_size),
                         interpolation=cv2.INTER_CUBIC).astype(np.float32) / 255.0
        img = (img - np.asarray(self.mean)) / np.asarray(self.std)
        return img.transpose(2, 0, 1)

    def embed_one(self, image: np.ndarray) -> Dict[str, np.ndarray]:
        """image: RGB uint8 [H, W, 3] holding one face ->
        {'id_cond': [1280], 'id_vit_hidden': [5, S, 1024], 'aligned': [512, 512, 3]}."""
        import cv2

        faces = self.detector(image)
        if not faces:
            raise ValueError("no face detected")
        f = faces[0]
        if f.landmarks is not None:
            face112 = warp_align(image, f.landmarks, 112)
            face512 = warp_align(image, f.landmarks, 512)
        else:
            x0, y0, x1, y1 = f.bbox.astype(int)
            crop = image[y0:y1, x0:x1]
            face112 = cv2.resize(crop, (112, 112), interpolation=cv2.INTER_AREA)
            face512 = cv2.resize(crop, (512, 512), interpolation=cv2.INTER_AREA)

        arc_in = (face112.astype(np.float32) / 127.5 - 1.0).transpose(2, 0, 1)
        arc_emb = np.asarray(self.arcface(arc_in[None]))[0]          # [512]

        clip_face = face512
        if self.face_parser is not None:
            parsing = np.asarray(self.face_parser(face512))
            clip_face, comp = parse_whiteout(face512, parsing,
                                             skip_bg_removal=self.skip_bg_removal)
            face512 = comp.astype(np.uint8)

        pooled, hidden = self.eva_apply(self._eva_input(clip_face)[None])
        id_cond = np.concatenate([arc_emb, np.asarray(pooled)[0]]).astype(np.float32)
        return {"id_cond": id_cond, "id_vit_hidden": np.asarray(hidden)[0], "aligned": face512}

    def process_split(self, images: Sequence[np.ndarray],
                      canvas_hw: Tuple[int, int] = (480, 720)) -> Dict[str, np.ndarray]:
        """Two face images -> the stacked conditioning and the side-by-side
        composite on a white canvas (reference `:296, 375-386`)."""
        import cv2

        embs = [self.embed_one(img) for img in images]
        h, w = canvas_hw
        canvas = np.full((h, w, 3), 255, np.uint8)
        cell = w // len(images)
        for i, e in enumerate(embs):
            side = min(cell, h)
            face = cv2.resize(e["aligned"], (side, side), interpolation=cv2.INTER_AREA)
            top = (h - side) // 2
            left = i * cell + (cell - side) // 2
            canvas[top:top + side, left:left + side] = face
        return {
            "id_cond": np.stack([e["id_cond"] for e in embs])[None],       # [1, I, 1280]
            "id_vit_hidden": np.stack([e["id_vit_hidden"] for e in embs])[None],
            "canvas": canvas,
        }


def build_default_processor(eva=None, seed: int = 0,
                            retinaface_checkpoint: Optional[str] = None,
                            bisenet_checkpoint: Optional[str] = None,
                            arcface_checkpoint: Optional[str] = None,
                            device: torch.device | str = "cuda") -> FaceProcessor:
    """The EVA-CLIP tower (`eva`, an `EVAVisionTower` with its weights; by
    default EVA02-CLIP-L drawn from `seed`) and the id embedder.  With the
    facexlib / insightface checkpoints the stack is the reference's:
    RetinaFace-ResNet50 detection, BiSeNet whiteout, ArcFace IR-100; each
    backend falls back on its own when its checkpoint is absent."""
    from .arcface import ArcFaceEmbedder, HashEmbedder

    if eva is None:
        from ..models.eva_clip import EVAVisionTower

        eva = EVAVisionTower.create(device=device,
                                    generator=torch.Generator(device).manual_seed(seed))
    face_parser = None
    if bisenet_checkpoint:
        from .bisenet import load_bisenet_parser

        face_parser = load_bisenet_parser(bisenet_checkpoint, device)
    arcface = (ArcFaceEmbedder.from_checkpoint(arcface_checkpoint, device)
               if arcface_checkpoint else HashEmbedder())

    @torch.no_grad()
    def eva_apply(images: np.ndarray):
        """numpy images -> (pooled, hidden) as float32 numpy (bf16 widens
        exactly)."""
        pooled, hidden = eva(torch.from_numpy(np.asarray(images, np.float32)).to(device))
        return pooled.float().cpu().numpy(), hidden.float().cpu().numpy()

    return FaceProcessor(
        eva_apply=eva_apply, arcface=arcface,
        detector=FaceDetector(retinaface_checkpoint=retinaface_checkpoint, device=device),
        face_parser=face_parser, eva_size=eva.cfg.image_size)

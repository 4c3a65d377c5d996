"""Mask-tracking tool (the port's copy of the root `tools/sam2_tools.py`):

    python -m bindyouravatar_tpu_torch.tools.sam2_tools --video output.mp4 \\
        --out_dir tracking_mask_results [--sam2_checkpoint sam2.1_hiera_large.pt] [--device cpu]

Writes per-identity mask PNGs `{out_dir}/{1,2}/annotated_frame_%05d.png`
and `valid_frame.json`: the layout two-stage inference and the trainer read
(`utils/masks.masks_to_routing_logits`).

Backends, as JAX's tool:
  * the SAM2 video predictor (`preprocess/sam2_video.py`) when a sam2.1
    checkpoint is given (`--sam2_checkpoint`, else `$BYA_SAM2_CKPT`): faces
    on frame 0 (`preprocess/face.FaceDetector`, RetinaFace from
    `$BYA_RETINAFACE_CKPT`), sorted left to right, each an object's point
    prompt (the nose landmark, else the box centre; the left and right
    default points when fewer than two faces are found), then
    `propagate_in_video`;
  * without a checkpoint, JAX's documented coarse masks (background
    subtraction split left / right), so the two-stage flow runs without
    weights.  This is the tool's behaviour, not a fallback from the device.
The predictor runs on `--device` (the card unless the CPU is asked for).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

import numpy as np


def _sam2_checkpoint(args_ckpt: Optional[str] = None) -> Optional[str]:
    return args_ckpt or os.environ.get("BYA_SAM2_CKPT")


def fallback_masks(frames: np.ndarray) -> np.ndarray:
    """[T, H, W, 3] -> [2, T, H, W] coarse per-side foreground masks."""
    import cv2

    t, h, w = frames.shape[:3]
    gray = np.stack([cv2.cvtColor(f, cv2.COLOR_RGB2GRAY) for f in frames])
    med = np.median(gray, axis=0)
    fg = (np.abs(gray.astype(np.float32) - med) > 12).astype(np.uint8)
    kernel = np.ones((7, 7), np.uint8)
    masks = np.zeros((2, t, h, w), np.uint8)
    half = w // 2
    for i in range(t):
        m = cv2.morphologyEx(fg[i], cv2.MORPH_CLOSE, kernel)
        m = cv2.morphologyEx(m, cv2.MORPH_OPEN, kernel)
        masks[0, i, :, :half] = m[:, :half]
        masks[1, i, :, half:] = m[:, half:]
    return masks


def sam2_masks(frames: np.ndarray, checkpoint: Optional[str] = None, predictor=None,
               device: str = "cuda") -> np.ndarray:
    """SAM2 video propagation from the faces found on frame 0 -> [2, T, H,
    W] uint8 masks.  `predictor` injects a built `SAM2VideoPredictor`."""
    import cv2

    from ..preprocess.face import FaceDetector

    t, h, w = frames.shape[:3]
    if predictor is None:
        from ..preprocess.sam2_video import load_sam2_predictor

        predictor = load_sam2_predictor(checkpoint, device=device)
    state = predictor.init_state(frames)

    faces = FaceDetector(retinaface_checkpoint=os.environ.get("BYA_RETINAFACE_CKPT"),
                         device=device)(frames[0])
    if len(faces) < 2:   # the left / right face-ish default prompts
        pts = [np.array([[w * 0.3, h * 0.4]]), np.array([[w * 0.7, h * 0.4]])]
    else:
        pts = [np.asarray([[(f.bbox[0] + f.bbox[2]) / 2 if f.landmarks is None
                            else f.landmarks[2, 0],
                            (f.bbox[1] + f.bbox[3]) / 2 if f.landmarks is None
                            else f.landmarks[2, 1]]])
               for f in faces[:2]]
    for oid, p in enumerate(pts, start=1):
        predictor.add_new_points(state, 0, oid, p.astype(np.float32), np.array([1]))

    masks = np.zeros((2, t, h, w), np.uint8)
    for fi, ids, logits in predictor.propagate_in_video(state):
        for j, _ in enumerate(ids[:2]):
            m = (logits[j] > 0).astype(np.uint8)
            masks[j, fi] = cv2.resize(m, (w, h), interpolation=cv2.INTER_NEAREST)
    return masks


def write_masks(masks: np.ndarray, out_dir: str) -> None:
    from PIL import Image

    n_id, t = masks.shape[:2]
    for i in range(n_id):
        d = os.path.join(out_dir, str(i + 1))
        os.makedirs(d, exist_ok=True)
        for f in range(t):
            Image.fromarray(masks[i, f] * 255).save(
                os.path.join(d, f"annotated_frame_{f:05d}.png"))
    with open(os.path.join(out_dir, "valid_frame.json"), "w") as f:
        json.dump({"valid_frames": [0, int(t - 1)]}, f)


def make_masks(video: str, out_dir: str, checkpoint: Optional[str] = None,
               device: str = "cuda") -> np.ndarray:
    """Every frame of `video` -> the masks (SAM2 with a checkpoint, else the
    coarse ones) written into `out_dir`; returns them [2, T, H, W]."""
    import cv2

    from ..utils.media import read_video_frames

    cap = cv2.VideoCapture(video)
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    frames = read_video_frames(video, list(range(n)))
    ckpt = _sam2_checkpoint(checkpoint)
    masks = sam2_masks(frames, ckpt, device=device) if ckpt else fallback_masks(frames)
    write_masks(masks, out_dir)
    return masks


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--video", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--sam2_checkpoint", default=None,
                   help="sam2.1 .pt checkpoint for the SAM2 predictor (default: "
                        "$BYA_SAM2_CKPT; the coarse masks when neither is set)")
    p.add_argument("--device", default="cuda", help="the card unless 'cpu' is asked for")
    args = p.parse_args(argv)
    masks = make_masks(args.video, args.out_dir, args.sam2_checkpoint, args.device)
    print(f"wrote {masks.shape[1]} mask frames x {masks.shape[0]} ids to {args.out_dir}")


if __name__ == "__main__":
    main()

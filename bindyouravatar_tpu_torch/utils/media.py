"""Video export, frame decoding and audio/video muxing (the port's copy of
the JAX package's `utils/media.py` and of `training/data.py`'s
`read_video_frames`, host-side numpy).

Frames are written with OpenCV (mp4v): no ffmpeg binary is needed for the
video.  The a/v mux keeps the reference's ffmpeg contract (skip 0.08 s of
audio, 16 kHz AAC) and copies the silent video when ffmpeg is absent.
OpenCV and scipy are imported inside the functions that use them, so the
module imports where neither is installed; a call that needs one raises.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Optional, Sequence

import numpy as np


def export_to_video(frames: np.ndarray, path: str, fps: int = 25) -> str:
    """frames: [T, H, W, 3] uint8 RGB or [T, 3, H, W] float in [-1, 1]."""
    import cv2

    if frames.ndim != 4:
        raise ValueError(f"bad frames shape {frames.shape}")
    if frames.shape[1] == 3 and frames.shape[-1] != 3:
        frames = frames.transpose(0, 2, 3, 1)
    if frames.dtype != np.uint8:
        frames = ((np.clip(frames, -1, 1) + 1) * 127.5).astype(np.uint8)
    _, h, w, _ = frames.shape
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    if not writer.isOpened():
        raise IOError(f"cannot open writer for {path}")
    for f in frames:
        writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    writer.release()
    return path


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


def merge_audio_video(video_path: str, audio_path: str, out_path: str,
                      audio_skip_seconds: float = 0.08) -> str:
    """Mux (reference `merge_audio_video`); copies the silent video when
    ffmpeg is missing."""
    if not ffmpeg_available():
        shutil.copyfile(video_path, out_path)
        return out_path
    cmd = ["ffmpeg", "-y", "-i", video_path, "-ss", str(audio_skip_seconds), "-i", audio_path,
           "-map", "0:v", "-map", "1:a", "-c:v", "copy", "-c:a", "aac", "-ar", "16000",
           "-shortest", out_path]
    subprocess.run(cmd, check=True, capture_output=True)
    return out_path


def merge_audio_files(paths: Sequence[str], out_path: str) -> str:
    """Mix wavs into one 16 kHz int16 wav (reference `tools/synthesize_audio.py`)."""
    from scipy.io import wavfile

    from ..preprocess.audio import mix_tracks, read_wav_mono_16k

    mixed: Optional[np.ndarray] = None
    for p in paths:
        a = read_wav_mono_16k(p)
        mixed = a if mixed is None else mix_tracks(mixed, a)
    wavfile.write(out_path, 16000, (mixed * 32767).astype(np.int16))
    return out_path


KPS_COLORS = [(255, 0, 0), (0, 255, 0), (0, 0, 255), (255, 255, 0), (255, 0, 255)]
KPS_LIMBS = [(0, 2), (1, 2), (3, 2), (4, 2)]


def draw_kps(height: int, width: int, kps_list, radius: int = 4) -> np.ndarray:
    """5-point facial keypoints on black (reference `draw_kps`): limb
    ellipses at 0.6 of the joint colour, then the coloured joints.
    kps_list: one [5, 2] array per face."""
    import cv2

    canvas = np.zeros((height, width, 3), np.uint8)
    for kps in kps_list:
        kps = np.asarray(kps, np.float32)
        for a, b in KPS_LIMBS:
            x, y = kps[[a, b], 0], kps[[a, b], 1]
            length = float(np.hypot(x[0] - x[1], y[0] - y[1]))
            angle = float(np.degrees(np.arctan2(y[0] - y[1], x[0] - x[1])))
            poly = cv2.ellipse2Poly((int(x.mean()), int(y.mean())), (int(length / 2), radius),
                                    int(angle), 0, 360, 1)
            cv2.fillConvexPoly(canvas, poly, [c * 0.6 for c in KPS_COLORS[a]])
        for i, (px, py) in enumerate(kps):
            cv2.circle(canvas, (int(px), int(py)), radius + 2, KPS_COLORS[i], -1)
    return canvas


def save_routing_video(routing: np.ndarray, grid, path: str, fps: int = 25) -> str:
    """Router mask visualisation (reference `draw_routing_logit`): routing
    [S, I] on the (t, h, w) grid, per-identity masks upscaled 8x into one
    mp4, identity 1 red, identity 2 green."""
    import cv2

    t, h, w = grid
    r = routing.reshape(t, h, w, -1)
    frames = []
    for f in range(t):
        img = np.zeros((h, w, 3), np.float32)
        img[..., 0] = r[f, ..., 0]
        if r.shape[-1] > 1:
            img[..., 1] = r[f, ..., 1]
        frames.append(cv2.resize((img * 255).astype(np.uint8), (w * 8, h * 8),
                                 interpolation=cv2.INTER_NEAREST))
    return export_to_video(np.stack(frames), path, fps)


def read_video_frames(path: str, indices: Sequence[int]) -> np.ndarray:
    """Decode the given frame indices with OpenCV -> [T, H, W, 3] uint8 RGB
    (the port's copy of JAX `training/data.py:read_video_frames`)."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"cannot open video {path}")
    want = sorted(set(int(i) for i in indices))
    got = {}
    pos, last = 0, want[-1]
    while pos <= last:
        ok, frame = cap.read()
        if not ok:
            break
        if pos in want:
            got[pos] = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        pos += 1
    cap.release()
    missing = [i for i in indices if i not in got]
    if missing:
        raise IOError(f"missing frames {missing[:4]}... in {path}")
    return np.stack([got[int(i)] for i in indices])

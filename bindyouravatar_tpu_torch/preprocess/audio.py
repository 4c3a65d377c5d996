"""Audio inputs of the CLI (the port of the JAX package's
`preprocess/audio.py`): reference-format precomputed wav2vec2 embeddings,
wav decoding, the two-speaker mix, and `extract_wav2vec_embeddings`, the
wav2vec2-base hidden states of a wav (`preprocess/wav2vec2.py`, the port's
own model in place of transformers').
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch


def load_precomputed(path: str) -> np.ndarray:
    """A reference-format `.pt` audio embedding [N, 12, 768] as float32."""
    t = torch.load(path, map_location="cpu", weights_only=True)
    arr = t.float().numpy() if hasattr(t, "float") else np.asarray(t, np.float32)
    if arr.ndim != 3:
        raise ValueError(f"expected [N,12,768]-like, got {arr.shape}")
    return arr.astype(np.float32)


def read_wav_mono_16k(path: str) -> np.ndarray:
    """A wav as mono float32 at 16 kHz (scipy; linear resample)."""
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    data = np.asarray(data, np.float32)
    if data.ndim == 2:
        data = data.mean(axis=1)
    if data.dtype.kind != "f":
        data = data / np.abs(data).max().clip(1e-6)
    if np.abs(data).max() > 1.5:            # int-scaled
        data = data / 32768.0
    if sr != 16000:
        n = int(round(len(data) * 16000 / sr))
        data = np.interp(np.linspace(0, len(data) - 1, n), np.arange(len(data)),
                         data).astype(np.float32)
    return data


def extract_wav2vec_embeddings(wav_path: str, num_pixel_frames: int, fps: float = 25.0,
                               model_dir: Optional[str] = None,
                               device: torch.device | str = "cuda") -> np.ndarray:
    """wav -> [num_pixel_frames, 12, 768] float32: the 12 layers' hidden
    states of wav2vec2-base over the raw 16 kHz samples (no feature-extractor
    normalisation, as in JAX), linearly resampled from ~50 a second to the
    video frames.  The model is an HF directory, `model_dir` or
    `$BYA_WAV2VEC_DIR`; without one it raises (precomputed `.pt` embeddings
    always work).  Runs on the card unless `device` says otherwise, in fp32."""
    from .wav2vec2 import extract, load_wav2vec2

    model_dir = model_dir or os.environ.get("BYA_WAV2VEC_DIR")
    if not model_dir or not os.path.isdir(model_dir):
        raise FileNotFoundError(
            "wav2vec2 checkpoint not available locally; pass precomputed "
            "audio embeddings (.pt) or set BYA_WAV2VEC_DIR")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to extract on the CPU")
    model = load_wav2vec2(model_dir, device=dev)
    wav = torch.from_numpy(read_wav_mono_16k(wav_path)).to(dev)
    return extract(model, wav, num_pixel_frames).cpu().numpy()


def mix_tracks(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Two-speaker wav mix, peak-normalised above 1 (reference
    `tools/synthesize_audio.py`)."""
    n = max(len(a), len(b))
    out = np.zeros(n, np.float32)
    out[: len(a)] += a
    out[: len(b)] += b
    peak = np.abs(out).max()
    if peak > 1.0:
        out = out / peak
    return out

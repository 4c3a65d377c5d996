"""Audio inputs of the CLI (the port's copy of the JAX package's
`preprocess/audio.py`, host-side): reference-format precomputed wav2vec2
embeddings, wav decoding and the two-speaker mix.  The wav2vec2 extractor
(`extract_wav2vec_embeddings`) is not ported (`ROADMAP.md`): requests take
precomputed embeddings.
"""

from __future__ import annotations

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

"""Training data on the host (the port's copy of the JAX package's
`training/data.py`, the parts the synthetic path needs).

`SyntheticAvatarDataset` gives samples of the real schema, equal to the JAX
package's bit for bit from the same seed; `ResumableSampler` keeps a cursor
that a checkpoint stores; `PrefetchLoader` builds batches in a thread
ahead of the consumer.  The loader hands each batch over together with
the sampler's state as it stood after that batch (`state_dict`), so a
checkpoint saves the cursor of the last batch consumed.  The JAX loader's
worker draws up to `prefetch + 1` batches ahead and its driver saves the
worker's cursor, so a resumed JAX run skips those samples.

The on-disk datasets (`AvatarVideoDataset`, `ReferenceLayoutDataset`:
OpenCV, PIL and the reference's directory layout) are not ported.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Dict, Iterator, List

import numpy as np

AUDIO_WINDOW_SLACK = 4  # window_size - window_stride (audio frames beyond video)


@dataclasses.dataclass
class ResumableSampler:
    """Random or sequential index sampler with a cursor a checkpoint
    stores (reference `dataloader.py:397-482`)."""
    length: int
    shuffle: bool = True
    seed: int = 0
    epoch: int = 0
    cursor: int = 0

    def _order(self) -> np.ndarray:
        if not self.shuffle:
            return np.arange(self.length)
        return np.random.default_rng(self.seed + self.epoch).permutation(self.length)

    def __iter__(self) -> Iterator[int]:
        while True:
            order = self._order()
            while self.cursor < self.length:
                idx = int(order[self.cursor])
                self.cursor += 1
                yield idx
            self.cursor = 0
            self.epoch += 1

    def state_dict(self) -> Dict[str, int]:
        return {"epoch": self.epoch, "cursor": self.cursor, "seed": self.seed}

    def load_state_dict(self, state: Dict[str, int]) -> None:
        self.epoch = int(state["epoch"])
        self.cursor = int(state["cursor"])
        self.seed = int(state.get("seed", self.seed))


def af_matrix_from_speaker(speaker_is_left: bool, num_ids: int = 2) -> np.ndarray:
    """The audio-face map (reference `get_af_matrix_infer`)."""
    eye = np.eye(num_ids, dtype=np.float32)
    return eye if speaker_is_left else 1.0 - eye


def maybe_drop_text(prompt: str, ratio: float, rng=None) -> str:
    """Caption dropout (reference `dataloader.py:995-996`): '' with
    probability `ratio` (default off in the reference)."""
    if ratio > 0 and float((rng or np.random).random()) < ratio:
        return ""
    return prompt


@dataclasses.dataclass
class SyntheticAvatarDataset:
    """Random samples of the training schema: video [T, 3, H, W] in
    [-1, 1], face crops, the left/right identity masks [I, T, H, W] and
    their union as the dense mask, audio features [I, T + 4, blocks, dim],
    the identity audio-face map."""
    length: int = 64
    num_frames: int = 9
    height: int = 64
    width: int = 96
    num_ids: int = 2
    audio_blocks: int = 12
    audio_dim: int = 768
    seed: int = 0

    def __len__(self):
        return self.length

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        rng = np.random.default_rng(self.seed + idx)
        t, h, w = self.num_frames, self.height, self.width
        half = w // 2
        masks = np.zeros((self.num_ids, t, h, w), np.float32)
        masks[0, :, :, :half] = 1.0
        if self.num_ids > 1:
            masks[1, :, :, half:] = 1.0
        return dict(
            video=rng.normal(0, 0.5, (t, 3, h, w)).astype(np.float32).clip(-1, 1),
            face_crops=rng.normal(0, 0.5, (self.num_ids, 3, 64, 64)).astype(np.float32),
            masks=masks,
            dense_mask=masks.max(axis=0),
            audio=rng.normal(0, 1, (self.num_ids, t + AUDIO_WINDOW_SLACK,
                                    self.audio_blocks, self.audio_dim)).astype(np.float32),
            af_matrix=np.eye(self.num_ids, dtype=np.float32),
            prompt="two people talking",
            single_face=False,
        )


def collate(samples: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack array fields on a new batch axis; other fields become lists."""
    out: Dict[str, Any] = {}
    for k, v in samples[0].items():
        if isinstance(v, np.ndarray):
            out[k] = np.stack([s[k] for s in samples])
        else:
            out[k] = [s[k] for s in samples]
    return out


class PrefetchLoader:
    """Batches built by a thread ahead of the consumer (a bounded queue).
    `state_dict()` is the sampler's state after the last batch `next`
    returned, which is what a checkpoint must store; the worker's own
    sampler runs up to `prefetch + 1` batches ahead of it."""

    def __init__(self, dataset, sampler: ResumableSampler, batch_size: int,
                 prefetch: int = 2):
        self.dataset, self.sampler, self.batch_size = dataset, sampler, batch_size
        self._state = sampler.state_dict()
        self.q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        it = iter(self.sampler)
        try:
            while not self._stop.is_set():
                idxs = [next(it) for _ in range(self.batch_size)]
                state = self.sampler.state_dict()
                self.q.put((collate([self.dataset[i] for i in idxs]), state))
        except Exception as e:  # handed to the consumer
            self.q.put(e)

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, Any]:
        item = self.q.get()
        if isinstance(item, Exception):
            raise item
        batch, self._state = item
        return batch

    def state_dict(self) -> Dict[str, int]:
        return dict(self._state)

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)

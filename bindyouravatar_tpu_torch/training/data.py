"""Training data on the host (the port's copy of the JAX package's
`training/data.py`).

The on-disk datasets read the reference's training layouts and give
samples equal to the JAX package's bit for bit on the same files:
`AvatarVideoDataset` (an index txt of `video_root,anno_json,anno_base`
rows, JSON annotations, bbox face crops, per-identity PNG mask
directories, audio `.pt` tracks) and `ReferenceLayoutDataset` (the
reference's exact tree: valid-frame and tracking JSONs, per-track mask
PNGs, refined bboxes, left/right audio embeddings).  Both retry a failing
sample on another index drawn from a seeded generator, log each error, and
raise `DatasetError` after `max_retries`.  OpenCV (decode, resize) and PIL
(mask PNGs) are imported inside them.
`SyntheticAvatarDataset` gives samples of the same schema from a seed,
equal to the JAX package's; `ResumableSampler` keeps a cursor that a
checkpoint stores; `PrefetchLoader` builds batches in a thread ahead of
the consumer.  The loader hands each batch over together with the
sampler's state as it stood after that batch (`state_dict`), so a
checkpoint saves the cursor of the last batch consumed.  The JAX loader's
worker draws up to `prefetch + 1` batches ahead and its driver saves the
worker's cursor, so a resumed JAX run skips those samples.
"""

from __future__ import annotations

import dataclasses
import json
import os
import queue
import threading
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.media import read_video_frames

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


def short_resize_and_pad(frames: np.ndarray, out_h: int = 480, out_w: int = 720) -> np.ndarray:
    """[T, H, W, C] uint8 (or float) -> [T, out_h, out_w, C] float32 in
    [-1, 1]: the short side resized to fit (INTER_AREA), the rest padded
    evenly (reference `_short_resize_and_crop`)."""
    import cv2

    t, h, w = frames.shape[:3]
    scale = min(out_h / h, out_w / w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    out = np.zeros((t, out_h, out_w, frames.shape[3]), np.float32)
    top, left = (out_h - nh) // 2, (out_w - nw) // 2
    for i in range(t):
        r = cv2.resize(frames[i], (nw, nh), interpolation=cv2.INTER_AREA)
        if r.ndim == 2:
            r = r[..., None]
        out[i, top:top + nh, left:left + nw] = r
    return out / 127.5 - 1.0


def square_expand_crop(frame: np.ndarray, bbox: Sequence[float], expand: float = 0.2,
                       out_size: int = 480) -> np.ndarray:
    """The square face crop around bbox (x0, y0, x1, y1), its side expanded
    by 20%, clipped to the frame and resized (reference `crop_images`)."""
    import cv2

    h, w = frame.shape[:2]
    x0, y0, x1, y1 = bbox
    cx, cy = (x0 + x1) / 2, (y0 + y1) / 2
    half = max(x1 - x0, y1 - y0) * (1 + expand) / 2
    xa, ya = int(max(0, cx - half)), int(max(0, cy - half))
    xb, yb = int(min(w, cx + half)), int(min(h, cy + half))
    crop = frame[ya:yb, xa:xb]
    if crop.size == 0:
        crop = frame
    return cv2.resize(crop, (out_size, out_size), interpolation=cv2.INTER_AREA)


def load_audio_embedding(path: str, start: int, num_pixel_frames: int) -> np.ndarray:
    """A `.pt` audio embedding [N, 12, 768] -> the training window, rows
    start - 2 .. start + frames + 2, zero outside [0, N) (reference
    `dataloader.py:951-969`)."""
    import torch

    t = torch.load(path, map_location="cpu", weights_only=True)
    arr = np.asarray(t.float().numpy() if hasattr(t, "numpy") else t, np.float32)
    need = num_pixel_frames + AUDIO_WINDOW_SLACK
    lo = start - AUDIO_WINDOW_SLACK // 2
    out = np.zeros((need,) + arr.shape[1:], np.float32)
    for i in range(need):
        j = lo + i
        if 0 <= j < arr.shape[0]:
            out[i] = arr[j]
    return out


def read_mask(path: str) -> np.ndarray:
    """A mask PNG as float32 luma 0..255 (PIL's `convert("L")`)."""
    from PIL import Image

    return np.asarray(Image.open(path).convert("L"), np.float32)


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


class DatasetError(RuntimeError):
    pass


def _masks_to_frames(ms: List[np.ndarray], height: int, width: int) -> np.ndarray:
    """Masks in 0..1 [T, H, W] -> resized and padded to the clip, 0..1."""
    m = short_resize_and_pad(np.stack(ms)[..., None] * 255.0, height, width)[..., 0]
    return (m + 1.0) / 2.0


class _Retrying:
    """Retry on error with a resample from a seeded generator, logging each
    error (reference `dataloader.py:1008-1041`)."""
    error_log: Optional[str]
    max_retries: int

    def _log_error(self, idx: int, err: Exception) -> None:
        if self.error_log:
            with open(self.error_log, "a") as f:
                f.write(f"{idx}\t{type(err).__name__}: {err}\n")

    def _retry(self, idx: int, rng: np.random.Generator, load) -> Dict[str, Any]:
        for _ in range(self.max_retries):
            try:
                return load(idx)
            except Exception as e:  # noqa: BLE001 - the reference's data fault tolerance
                self._log_error(idx, e)
                idx = int(rng.integers(0, len(self)))
        raise DatasetError(f"exceeded retries at {idx}")


@dataclasses.dataclass
class AvatarVideoDataset(_Retrying):
    """The index txt's `video_root,anno_json,anno_base` rows
    (`dataloader.py:529-556`): per sample a JSON annotation (video name,
    caption, valid frames, face bboxes by identity, audio `.pt` paths,
    speaker side), per-identity PNG mask directories `{anno_base}/{i}`.
    Samples: video [T, 3, H, W] in [-1, 1], face_crops [I, 3, 480, 480],
    masks [I, T, H, W], dense_mask [T, H, W], audio [tracks, T + 4, 12,
    768], af_matrix [I, I], prompt, single_face."""
    index_file: str
    num_frames: int = 49
    height: int = 480
    width: int = 720
    num_ids: int = 2
    error_log: Optional[str] = "error_log.txt"
    max_retries: int = 8
    text_drop_ratio: float = 0.0

    def __post_init__(self):
        self.rows: List[Tuple[str, str, str]] = []
        with open(self.index_file) as f:
            for line in f:
                parts = line.strip().split(",")
                if len(parts) >= 3:
                    self.rows.append((parts[0], parts[1], parts[2]))
        if not self.rows:
            raise ValueError(f"empty index {self.index_file}")

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        return self._retry(idx, np.random.default_rng(idx), self._load)

    def _load(self, idx: int) -> Dict[str, Any]:
        video_root, anno_json, anno_base = self.rows[idx]
        with open(anno_json) as f:
            anno = json.load(f)
        prompt = maybe_drop_text(anno.get("caption", ""), self.text_drop_ratio)
        valid = anno.get("valid_frames")
        start = int(valid[0]) if valid else 0
        frames = read_video_frames(os.path.join(video_root, anno["video"]),
                                   list(range(start, start + self.num_frames)))
        video = short_resize_and_pad(frames, self.height, self.width).transpose(0, 3, 1, 2)

        bboxes = anno.get("bboxes", {})
        crops = []
        for i in range(self.num_ids):
            bb = bboxes.get(str(i + 1))
            crops.append(square_expand_crop(frames[0], bb).transpose(2, 0, 1) if bb
                         else np.zeros((3, 480, 480), np.float32))
        face_crops = np.stack(crops).astype(np.float32) / 127.5 - 1.0

        masks = []
        for i in range(self.num_ids):
            mdir = os.path.join(anno_base, str(i + 1))
            if os.path.isdir(mdir):
                files = sorted(f for f in os.listdir(mdir) if f.endswith(".png"))
                files = files[start:start + self.num_frames]
                masks.append(_masks_to_frames(
                    [read_mask(os.path.join(mdir, f)) / 255.0 for f in files],
                    self.height, self.width))
            else:
                masks.append(np.zeros((self.num_frames, self.height, self.width), np.float32))
        dense = np.maximum(masks[0], masks[1]) if self.num_ids == 2 else masks[0]

        tracks = [load_audio_embedding(p, start, self.num_frames)
                  for p in anno.get("audio_emb", [])[: self.num_ids]]
        audio = np.stack(tracks) if tracks else np.zeros(
            (0, self.num_frames + AUDIO_WINDOW_SLACK, 12, 768), np.float32)
        return dict(video=video.astype(np.float32), face_crops=face_crops,
                    masks=np.stack(masks), dense_mask=dense, audio=audio,
                    af_matrix=af_matrix_from_speaker(bool(anno.get("speaker_left", True)),
                                                     self.num_ids),
                    prompt=prompt, single_face=len(tracks) <= 1)


def get_valid_segments(valid_frame: Dict[str, list], tolerance: int = 5):
    """Runs of valid face/head frames (the union of 'face' and 'head'),
    a new run where a gap exceeds `tolerance` (reference
    `dataloader.py:84-109`)."""
    pos = sorted(set(valid_frame.get("face", [])) | set(valid_frame.get("head", [])))
    if not pos:
        return []
    segs, cur = [], [pos[0]]
    for a, b in zip(pos, pos[1:]):
        if b - a <= tolerance:
            cur.append(b)
        else:
            segs.append(cur)
            cur = [b]
    segs.append(cur)
    return segs


def generate_frame_indices_for_face(n_frames: int, valid_frame: Dict[str, list],
                                    tolerance: int = 7, skip_start: int = 2, skip_end: int = 2,
                                    rng: Optional[np.random.Generator] = None):
    """n frames inside the longest valid run, its ends trimmed for the audio
    window, at a random start (`rng`), or the run repeated and sorted when
    it is short (reference `dataloader.py:130-172`)."""
    segs = get_valid_segments(valid_frame, tolerance)
    if not segs:
        raise ValueError("no valid face frames")
    seg = max(segs, key=len)
    seg = seg[skip_start: len(seg) - skip_end] or seg
    if len(seg) >= n_frames:
        max_start = len(seg) - n_frames
        start = int(rng.integers(0, max_start + 1)) if rng is not None and max_start > 0 else 0
        return list(seg[start:start + n_frames])
    out = list(seg)
    i = 0
    while len(out) < n_frames:
        out.append(seg[i % len(seg)])
        i += 1
    return sorted(out)


@dataclasses.dataclass
class ReferenceLayoutDataset(_Retrying):
    """The reference's exact training layout (`dataloader.py:484-1041`):
    index rows `sub_root,anno_json,anno_base`, `anno_json` a JSON list of
    {path, cap, fps, duration, speaker}; under
    `{anno_base}/track_masks_data/{base}/` valid_frame.json,
    corresponding_data.json and tracking_mask_results/{track}/
    annotated_frame_%05d.png; `{anno_base}/refine_bbox_jsons/{base}.json`;
    audio `{anno_base}/audio_emb[/left_audio|/right_audio]/{base}.pt`.
    Samples of `AvatarVideoDataset`'s schema."""
    index_file: str
    num_frames: int = 49
    height: int = 480
    width: int = 720
    num_ids: int = 2
    skip_frames_start: int = 2
    skip_frames_end: int = 2
    miss_tolerance: int = 0
    error_log: Optional[str] = "error_log.txt"
    max_retries: int = 8
    seed: int = 0
    text_drop_ratio: float = 0.0

    def __post_init__(self):
        self.samples: List[Dict[str, Any]] = []
        with open(self.index_file) as f:
            rows = [line.strip().split(",") for line in f if line.strip()]
        for sub_root, anno, anno_base in rows:
            with open(anno) as f:
                items = json.load(f)
            for it in items:
                if it.get("fps", 0) * it.get("duration", 0) < self.num_frames:
                    continue
                base = os.path.basename(it["path"])
                self.samples.append(dict(video=os.path.join(sub_root, base + ".mp4"), base=base,
                                         anno_base=anno_base, cap=it.get("cap", ""),
                                         speaker=it.get("speaker", "left")))
        if not self.samples:
            raise ValueError(f"no usable samples in {self.index_file}")

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        rng = np.random.default_rng(self.seed + idx)
        return self._retry(idx, rng, lambda i: self._load(i, rng))

    def _load(self, idx: int, rng: np.random.Generator) -> Dict[str, Any]:
        s = self.samples[idx]
        track_dir = os.path.join(s["anno_base"], "track_masks_data", s["base"])
        with open(os.path.join(track_dir, "valid_frame.json")) as f:
            valid_frame = json.load(f)
        with open(os.path.join(track_dir, "corresponding_data.json")) as f:
            corresponding = json.load(f)
        bbox_path = os.path.join(s["anno_base"], "refine_bbox_jsons", f"{s['base']}.json")
        bbox_data = {}
        if os.path.isfile(bbox_path):
            with open(bbox_path) as f:
                bbox_data = json.load(f)
        mask_root = os.path.join(track_dir, "tracking_mask_results")

        valid_ids = [k for k, v in corresponding.items() if "face" in v or "head" in v]
        valid_ids = valid_ids[: self.num_ids]
        if not valid_ids:
            raise ValueError("no valid ids")
        vf0 = valid_frame[valid_ids[0]] if valid_ids[0] in valid_frame else valid_frame
        indices = generate_frame_indices_for_face(
            self.num_frames, vf0, self.miss_tolerance or 7, self.skip_frames_start,
            self.skip_frames_end, rng)
        frames = read_video_frames(s["video"], indices)
        video = short_resize_and_pad(frames, self.height, self.width).transpose(0, 3, 1, 2)

        def bbox_for(frame: int, vid: str):
            entry = bbox_data.get(str(frame), {})
            for kind in ("head", "face"):
                for item in entry.get(kind, []):
                    if item.get("new_track_id") == int(vid):
                        b = item["box"]
                        return (b["x1"], b["y1"], b["x2"], b["y2"])
            return None

        masks, crops = [], []
        for slot in range(self.num_ids):
            if slot < len(valid_ids):
                vid = valid_ids[slot]
                cd = corresponding[vid]
                track_id = cd.get("face", cd.get("head", cd.get("person")))
                ms = [(read_mask(os.path.join(mask_root, str(track_id),
                                              f"annotated_frame_{int(fr):05d}.png")) > 0)
                      .astype(np.float32) for fr in indices]
                masks.append(_masks_to_frames(ms, self.height, self.width))
                bb = bbox_for(indices[0], vid)
                crops.append(square_expand_crop(frames[0], bb).transpose(2, 0, 1)
                             if bb is not None else np.zeros((3, 480, 480), np.float32))
            else:       # the phantom second identity (reference `dataloader.py:911-940`)
                masks.append(np.zeros((self.num_frames, self.height, self.width), np.float32))
                crops.append(np.zeros((3, 480, 480), np.float32))
        dense = np.max(np.stack(masks), axis=0)

        # the left / right tracks, else the single mixed one
        start = int(indices[0])
        emb = os.path.join(s["anno_base"], "audio_emb")
        paths = [os.path.join(emb, sub, f"{s['base']}.pt") for sub in ("left_audio",
                                                                       "right_audio")]
        paths = [p for p in paths if os.path.isfile(p)]
        if not paths and os.path.isfile(os.path.join(emb, f"{s['base']}.pt")):
            paths = [os.path.join(emb, f"{s['base']}.pt")]
        tracks = [load_audio_embedding(p, start, self.num_frames) for p in paths]
        audio = (np.stack(tracks) if tracks else
                 np.zeros((0, self.num_frames + AUDIO_WINDOW_SLACK, 12, 768), np.float32))
        return dict(video=video.astype(np.float32),
                    face_crops=np.stack(crops).astype(np.float32) / 127.5 - 1.0,
                    masks=np.stack(masks), dense_mask=dense, audio=audio,
                    af_matrix=af_matrix_from_speaker(s["speaker"] == "left", self.num_ids),
                    prompt=maybe_drop_text(s["cap"], self.text_drop_ratio),
                    single_face=len(valid_ids) == 1)


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

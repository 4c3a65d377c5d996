"""Request-level serving around the pipeline (port of
`bindyouravatar_tpu/serving/server.py`, one request per launch).

`InferenceServer` owns one pipeline and runs two threads over a request
queue: a PREP thread stages request n+1's tensors on the device while the
COMPUTE thread runs request n's `generate`.  Every result carries per-stage
wall timings.  Cross-clip batching, streaming decode and the HTTP front end
are not ported yet (ROADMAP queue A).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, Optional

import numpy as np
import torch


@dataclasses.dataclass
class GenerationRequest:
    """One clip-generation request (tensor contract = `pipeline.generate`)."""
    prompt_embeds: np.ndarray                 # [1, L, text_dim]
    image: np.ndarray                         # [1, 1, 3, H, W] in [-1, 1]
    negative_prompt_embeds: Optional[np.ndarray] = None
    id_cond: Optional[np.ndarray] = None        # [1, I, 1280]
    id_vit_hidden: Optional[np.ndarray] = None  # [1, I, 5, 577, 1024]
    audio_embeds: Optional[np.ndarray] = None  # [1, tracks, A, 12, 768]
    mute_embeds: Optional[np.ndarray] = None
    af_matrix: Optional[np.ndarray] = None
    seed: int = 0
    decode: bool = True
    request_id: str = ""


@dataclasses.dataclass
class GenerationResult:
    request_id: str
    video: np.ndarray                         # [1, T, 3, H, W] (or latents)
    timings: Dict[str, float]


class InferenceServer:
    """Double-buffered request server over one pipeline on one device."""

    def __init__(self, pipeline, device: torch.device | str):
        self.pipeline = pipeline
        self.device = torch.device(device)
        self._submit_q: "queue.Queue" = queue.Queue(maxsize=64)
        self._ready_q: "queue.Queue" = queue.Queue(maxsize=1)
        self._stop = threading.Event()
        self._served_lock = threading.Lock()
        self.requests_served = 0
        self._prep_thread = threading.Thread(target=self._prep_loop, daemon=True)
        self._compute_thread = threading.Thread(target=self._compute_loop, daemon=True)
        self._prep_thread.start()
        self._compute_thread.start()

    def submit(self, req: GenerationRequest) -> "Future[GenerationResult]":
        if self._stop.is_set():
            raise RuntimeError("server closed")
        fut: "Future[GenerationResult]" = Future()
        self._submit_q.put((req, fut))
        return fut

    def close(self) -> None:
        """Stop both threads; requests still queued fail with 'server closed'."""
        self._stop.set()
        self._submit_q.put(None)
        self._prep_thread.join(timeout=120)
        while True:   # make room for the compute thread's sentinel
            try:
                self._ready_q.put_nowait(None)
                break
            except queue.Full:
                try:
                    self._fail(self._ready_q.get_nowait())
                except queue.Empty:
                    pass
        self._compute_thread.join(timeout=120)
        for q in (self._submit_q, self._ready_q):
            while True:
                try:
                    self._fail(q.get_nowait())
                except queue.Empty:
                    break

    @staticmethod
    def _fail(item) -> None:
        if item is not None and not item[1].done():
            item[1].set_exception(RuntimeError("server closed"))

    def _prep_loop(self) -> None:
        while not self._stop.is_set():
            item = self._submit_q.get()
            if item is None:
                return
            req, fut = item
            if not fut.set_running_or_notify_cancel():
                continue
            t0 = time.perf_counter()
            try:
                staged = self._prepare(req)
            except Exception as e:   # noqa: BLE001 - surfaced through the future
                fut.set_exception(e)
                continue
            staged_item = (req, fut, staged, time.perf_counter() - t0)
            while True:   # bounded put: give up if the server is closing
                try:
                    self._ready_q.put(staged_item, timeout=0.5)
                    break
                except queue.Full:
                    if self._stop.is_set():
                        self._fail(staged_item)
                        return

    def _prepare(self, req: GenerationRequest) -> Dict[str, Any]:
        dev = lambda x: None if x is None else torch.as_tensor(x).to(self.device)
        pe = dev(req.prompt_embeds)
        neg = (dev(req.negative_prompt_embeds) if req.negative_prompt_embeds is not None
               else torch.zeros_like(pe))
        cond = {}
        if self.pipeline.dit.cfg.is_train_face and req.id_cond is not None:
            cond["id_cond"] = dev(req.id_cond)
            cond["id_vit_hidden"] = dev(req.id_vit_hidden)
        if self.pipeline.dit.cfg.is_train_audio and req.audio_embeds is not None:
            cond["audio_embeds"] = dev(req.audio_embeds)
            if req.mute_embeds is not None:
                cond["mute_embeds"] = dev(req.mute_embeds)
        if req.af_matrix is not None:
            cond["af_matrix"] = dev(req.af_matrix)
        staged = dict(prompt_embeds=pe, negative_prompt_embeds=neg, image=dev(req.image),
                      cond=cond)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return staged

    def _compute_loop(self) -> None:
        while True:
            item = self._ready_q.get()
            if item is None:
                return
            req, fut, staged, prep_s = item
            timings: Dict[str, float] = {"prep_s": prep_s}
            t0 = time.perf_counter()
            try:
                gen = torch.Generator(self.device).manual_seed(req.seed)
                out = self.pipeline.generate(
                    staged["prompt_embeds"], staged["negative_prompt_embeds"], staged["image"],
                    gen, decode=req.decode, timings=timings, **staged["cond"])
                video = out.cpu().numpy()
            except Exception as e:   # noqa: BLE001 - surfaced through the future
                fut.set_exception(e)
                continue
            timings["compute_s"] = time.perf_counter() - t0
            with self._served_lock:
                self.requests_served += 1
            fut.set_result(GenerationResult(request_id=req.request_id, video=video,
                                            timings=timings))

"""Request-level serving around the pipeline (port of
`bindyouravatar_tpu/serving/server.py`).

`InferenceServer` owns one pipeline and runs two threads over a request
queue: a PREP thread stages request n+1's tensors on the device while the
COMPUTE thread runs request n's `generate`.  With `batch_max > 1`
co-batchable requests (same shapes, same conditioning, same decode flag)
are stacked into one denoise.  A request with `stream_chunk_frames`
decodes through `CausalVAE.decode_stream` and hands each chunk to its
`on_chunk` as it lands; a request's `forced_routing` replaces the
predicted routing (`pipeline.denoise(routing_forcing=...)`).  Every result
carries per-stage wall timings and its batch size.  `serve_http` puts a
stdlib HTTP/JSON front end on a server (arrays travel as `.npy` paths).

Over several ranks (every rank launched by `torchrun`; a DiT split by
`parallel.tp.shard_params_tp`, or a pipeline whose `sp_group` runs the
joint attention as a ring) each rank builds the server with that process
`group`: its rank 0 owns the queue, the batching and the HTTP front end,
and broadcasts each batch's prepared inputs and request seeds before it
computes; the other ranks run `follow()`, which takes the same batches and
runs the same step in lockstep until rank 0's `close()` broadcasts the
stop.  Each rank draws the same noise from the same seeds.
"""

from __future__ import annotations

import dataclasses
import json
import os
import queue
import sys
import tempfile
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional

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
    forced_routing: Optional[np.ndarray] = None   # [1, S, I]
    seed: int = 0
    decode: bool = True
    request_id: str = ""
    # streaming decode: chunks of this many LATENT frames, each handed to
    # `on_chunk(start_pixel_frame, chunk [1, t, 3, H, W])` as it lands
    stream_chunk_frames: Optional[int] = None
    on_chunk: Optional[Callable[[int, np.ndarray], Any]] = None


@dataclasses.dataclass
class GenerationResult:
    request_id: str
    video: np.ndarray                         # [1, T, 3, H, W] (or latents)
    timings: Dict[str, float]


class InferenceServer:
    """Double-buffered request server over one pipeline on one device.

    `batch_max > 1` enables cross-clip batching: the compute thread waits
    up to `batch_wait_s` after a request for co-batchable ones and stacks
    them into ONE denoise.  Seeds: a request alone draws its initial
    latents and then its per-step SDE noise from `torch.Generator(device)
    .manual_seed(seed)`.  In a batch each request's initial latents are
    that generator's first draw, as alone; the batch's SDE noise continues
    the first request's generator at the batch's shape, so it is shared
    across the batch and differs from the requests' solo runs (JAX shares
    its loop key the same way).  Each clip of a batch then decodes on its
    own: streamed when it asks for that, else whole (one clip's decode
    activations at a time).
    """

    def __init__(self, pipeline, device: torch.device | str, max_queue: int = 64,
                 batch_max: int = 1, batch_wait_s: float = 0.25, group=None):
        self.pipeline = pipeline
        self.device = torch.device(device)
        self.group = group
        self._src = 0 if group is None else torch.distributed.get_global_rank(group, 0)
        if group is not None and torch.distributed.get_rank(group) != 0:
            self.requests_served = 0
            return          # a follower: `follow()` runs its loop
        self.batch_max = max(1, batch_max)
        self.batch_wait_s = batch_wait_s
        self._submit_q: "queue.Queue" = queue.Queue(maxsize=max_queue)
        # depth batch_max: prepared requests pool up for a batch (depth 1 is
        # the classic double buffer)
        self._ready_q: "queue.Queue" = queue.Queue(maxsize=self.batch_max)
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
        if req.forced_routing is not None:
            cond["routing_forcing"] = dev(req.forced_routing)
        staged = dict(prompt_embeds=pe, negative_prompt_embeds=neg, image=dev(req.image),
                      cond=cond)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return staged

    @staticmethod
    def _batchable(a, b) -> bool:
        """Same tensor shapes, same conditioning keys, same decode flag
        (streaming requests co-batch: only their decode is their own)."""
        sa, sb = a[2], b[2]
        if a[0].decode != b[0].decode or set(sa["cond"]) != set(sb["cond"]):
            return False
        if any(sa[k].shape != sb[k].shape
               for k in ("prompt_embeds", "negative_prompt_embeds", "image")):
            return False
        return all(sa["cond"][k].shape == sb["cond"][k].shape for k in sa["cond"])

    def follow(self) -> None:
        """A follower rank's loop: take each batch the group's rank 0
        broadcasts and run it, until the stop message.  A batch that raises
        is logged and skipped, as rank 0 fails its futures and goes on."""
        from types import SimpleNamespace

        while True:
            msg = self._broadcast(None)
            if msg is None:
                return
            reqs = [SimpleNamespace(seed=seed, decode=decode, stream_chunk_frames=chunks,
                                    on_chunk=None) for seed, decode, chunks in msg["reqs"]]
            dev = lambda d: {k: dev(v) if isinstance(v, dict) else v.to(self.device)
                             for k, v in d.items()}
            try:
                self._generate(reqs, [dev(st) for st in msg["staged"]], {})
            except Exception as e:   # noqa: BLE001 - rank 0 fails the batch's futures
                # rank 0 hit the same error on the same batch and goes on to
                # the next one: stay in step with it
                print(f"[follow] batch failed on rank {torch.distributed.get_rank()}: {e!r}",
                      file=sys.stderr, flush=True)
                continue
            self.requests_served += len(reqs)

    def _broadcast(self, msg):
        """Rank 0's `msg` on every rank of the group."""
        box = [msg]
        torch.distributed.broadcast_object_list(box, src=self._src, group=self.group)
        return box[0]

    def _compute_loop(self) -> None:
        try:
            self._compute_batches()
        finally:
            if self.group is not None:
                self._broadcast(None)          # the followers' stop

    def _compute_batches(self) -> None:
        pending = None    # taken while gathering a batch, but not co-batchable: runs next
        while True:
            item, pending = (pending if pending is not None else self._ready_q.get()), None
            if item is None:
                return
            items, stop = [item], False
            deadline = time.perf_counter() + self.batch_wait_s
            while len(items) < self.batch_max:
                try:
                    nxt = self._ready_q.get(timeout=max(deadline - time.perf_counter(), 0.0))
                except queue.Empty:
                    break
                if nxt is None:          # closing: finish this batch, then stop
                    stop = True
                    break
                if not self._batchable(item, nxt):
                    pending = nxt
                    break
                items.append(nxt)
            t0 = time.perf_counter()
            timings: Dict[str, float] = {}
            try:
                videos = self._run(items, timings)
            except Exception as e:   # noqa: BLE001 - surfaced through the futures
                for it in items:
                    it[1].set_exception(e)
            else:
                timings["compute_s"] = time.perf_counter() - t0
                timings["batch_size"] = float(len(items))
                with self._served_lock:
                    self.requests_served += len(items)
                for (req, fut, _, prep_s), video in zip(items, videos):
                    fut.set_result(GenerationResult(request_id=req.request_id, video=video,
                                                    timings={"prep_s": prep_s, **timings}))
            if stop:
                return

    @torch.inference_mode()
    def _run(self, items, timings: Dict[str, float]) -> List[np.ndarray]:
        """One `generate` over the stacked requests of `items`; one video
        (or latents) per request, decoded as the docstring of the class
        says; the stage seconds go into `timings`.  With a group the batch
        goes to the followers first."""
        reqs, staged = [it[0] for it in items], [it[2] for it in items]
        if self.group is not None:
            cpu = lambda d: {k: cpu(v) if isinstance(v, dict) else v.cpu() for k, v in d.items()}
            self._broadcast({"reqs": [(r.seed, r.decode, r.stream_chunk_frames) for r in reqs],
                             "staged": [cpu(st) for st in staged]})
        return self._generate(reqs, staged, timings)

    @torch.inference_mode()
    def _generate(self, reqs, staged, timings: Dict[str, float]) -> List[np.ndarray]:
        pipe = self.pipeline
        cat = lambda xs: torch.cat(xs, dim=0)
        gens = [torch.Generator(self.device).manual_seed(r.seed) for r in reqs]
        latents = None
        if len(reqs) > 1:
            c, vae = pipe.cfg, pipe.vae.cfg
            img = staged[0]["image"]
            shape = (1, (c.num_frames - 1) // pipe.dit.cfg.temporal_compression_ratio + 1,
                     vae.latent_channels, img.shape[-2] // vae.spatial_compression_ratio,
                     img.shape[-1] // vae.spatial_compression_ratio)
            latents = cat([torch.randn(shape, generator=g, device=self.device,
                                       dtype=torch.float32) for g in gens])
        whole = len(reqs) == 1 and reqs[0].decode and not reqs[0].stream_chunk_frames
        out = pipe.generate(
            cat([s["prompt_embeds"] for s in staged]),
            cat([s["negative_prompt_embeds"] for s in staged]),
            cat([s["image"] for s in staged]), gens[0], decode=whole, latents=latents,
            timings=timings, **{k: cat([s["cond"][k] for s in staged]) for k in staged[0]["cond"]})
        if whole or not reqs[0].decode:
            stacked = out.cpu().numpy()
            return [stacked[i:i + 1] for i in range(len(reqs))]
        t0 = time.perf_counter()
        videos = []
        for i, r in enumerate(reqs):
            chunks = []
            for start, chunk in pipe.vae.decode_stream(out[i:i + 1], r.stream_chunk_frames):
                chunk = chunk.cpu().numpy()
                if r.stream_chunk_frames and r.on_chunk is not None:
                    r.on_chunk(int(start), chunk)
                chunks.append(chunk)
            videos.append(np.concatenate(chunks, axis=1))
        timings["decode_s"] = time.perf_counter() - t0
        return videos


# ---------------------------------------------------------------- HTTP
def serve_http(server: InferenceServer, host: str = "127.0.0.1", port: int = 8976,
               block: bool = True, data_root: Optional[str] = None):
    """Minimal stdlib HTTP front end (JAX `serve_http`).

    POST /generate with JSON {"prompt_embeds": "<path.npy>", "image":
    "<path.npy>", optional conditioning paths, "seed": int, "output":
    "<path.npy>"} -> {"request_id", "output", "timings"}; with
    "stream_chunk_frames": n the reply is NDJSON, one line per decoded
    chunk (saved as `<output>.chunkNNN.npy`) and a final {"done": true}
    line.  GET /healthz -> {"ok": true, "served": n}.

    Requests name filesystem paths, so by default only loopback binds are
    safe.  With `data_root` every request path (inputs and the output) must
    resolve inside it: set it before binding another address.
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    array_fields = ("prompt_embeds", "negative_prompt_embeds", "image", "id_cond",
                    "id_vit_hidden", "audio_embeds", "mute_embeds", "af_matrix",
                    "forced_routing")
    root = os.path.realpath(data_root) if data_root else None
    default_out = (os.path.join(tempfile.gettempdir(), "bya_out.npy") if root is None
                   else "bya_out.npy")

    def _check_path(p: str) -> str:
        if root is None:
            return p
        rp = os.path.realpath(os.path.join(root, p))
        if not (rp == root or rp.startswith(root + os.sep)):
            raise PermissionError(f"path escapes data_root: {p}")
        return rp

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):   # quiet
            pass

        def _reply(self, code, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"ok": True, "served": server.requests_served})
            else:
                self._reply(404, {"error": "not found"})

        def _stream(self, spec, req: GenerationRequest):
            """NDJSON reply: one line per decoded chunk as it lands, then a
            final {"done": true} line; close-delimited (no Content-Length)."""
            out_base = spec.get("output", default_out)
            chunk_q: "queue.Queue" = queue.Queue()
            req.stream_chunk_frames = int(spec["stream_chunk_frames"])
            req.on_chunk = lambda start, arr: chunk_q.put((start, arr))
            fut = server.submit(req)
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Connection", "close")
            self.end_headers()

            def _line(payload):
                self.wfile.write((json.dumps(payload) + "\n").encode())
                self.wfile.flush()

            # the headers are out: from here an error is an NDJSON error line
            try:
                idx = 0
                deadline = time.monotonic() + float(spec.get("timeout_s", 3600))
                while True:
                    try:
                        start, arr = chunk_q.get(timeout=0.2)
                    except queue.Empty:
                        if fut.done() and chunk_q.empty():
                            break
                        if time.monotonic() > deadline:
                            fut.cancel()
                            _line({"error": "timeout"})
                            return
                        continue
                    path = _check_path(f"{out_base}.chunk{idx:03d}.npy")
                    np.save(path, arr)
                    _line({"chunk": idx, "start_frame": int(start), "frames": int(arr.shape[1]),
                           "path": path})
                    idx += 1
                result = fut.result(timeout=0)
                _line({"done": True, "request_id": result.request_id, "chunks": idx,
                       "timings": result.timings})
            except BrokenPipeError:
                fut.cancel()
            except Exception as e:   # noqa: BLE001 - the NDJSON error line
                try:
                    _line({"error": f"{type(e).__name__}: {e}"})
                except OSError:
                    pass

        def do_POST(self):
            if self.path != "/generate":
                self._reply(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                spec = json.loads(self.rfile.read(n) or b"{}")
                kw = {f: np.load(_check_path(spec[f])) for f in array_fields if f in spec}
                req = GenerationRequest(seed=int(spec.get("seed", 0)),
                                        request_id=str(spec.get("request_id", "")),
                                        decode=bool(spec.get("decode", True)), **kw)
                if spec.get("stream_chunk_frames"):
                    self._stream(spec, req)
                    return
                result = server.submit(req).result(timeout=float(spec.get("timeout_s", 3600)))
                out_path = _check_path(spec.get("output", default_out))
                np.save(out_path, result.video)
                self._reply(200, {"request_id": result.request_id, "output": out_path,
                                  "timings": result.timings})
            except Exception as e:   # noqa: BLE001 - the JSON error reply
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

    httpd = ThreadingHTTPServer((host, port), Handler)
    if block:
        httpd.serve_forever()
    else:
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd

"""The port's serving layer on the CPU: `CausalVAE.decode_stream`, the
server's forced routing, batching, streaming decode and `close()`, and the
`serve_http` front end.  Tiny face + audio DiT and tiny VAE (the JAX
`DiT.tiny` shapes) on realistic weights converted from the JAX init.

`decode_stream` is held against JAX's (fp32: chunks within 1e-5 of the
output's magnitude, the same start frames).  The server's paths, which
draw from torch generators JAX's RNG cannot feed, are held against the
port's own `pipeline.generate` on the same inputs, bit for bit.
"""

import json
import threading
import types
import urllib.error
import urllib.request
from concurrent.futures import wait

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bindyouravatar_tpu.config import VAEConfig as JVAEConfig
from bindyouravatar_tpu.models.dit import DiT as JDiT
from bindyouravatar_tpu.models.vae import CausalVAE as JCausalVAE
from bindyouravatar_tpu_torch.config import PipelineConfig
from bindyouravatar_tpu_torch.convert import jax_params_to_torch
from bindyouravatar_tpu_torch.models import vae as tvae
from bindyouravatar_tpu_torch.models.dit import DiT
from bindyouravatar_tpu_torch.models.vae import CausalVAE
from bindyouravatar_tpu_torch.pipeline.pipeline import BindYourAvatarPipeline
from bindyouravatar_tpu_torch.serving import GenerationRequest, InferenceServer, serve_http
from torch_port_utils import max_err, realistic, threads_per_worker

STEPS = 2
LATENT_FRAMES = 7          # decode_stream's chunks: 3 + 2 + 2 at chunk 2, 4 + 3 at chunk 3



@pytest.fixture(autouse=True, scope="module")
def _threads():
    with threads_per_worker():
        yield

@pytest.fixture(scope="module")
def models():
    """(JAX vae, its params, the port's pipeline on the same weights)."""
    jd = JDiT.tiny()
    jv = JCausalVAE(JVAEConfig(block_out_channels=(8, 8, 16, 16), layers_per_block=1,
                               latent_channels=4, norm_num_groups=4, dtype=jnp.float32))
    dp = realistic(jax.eval_shape(jd.init, jax.random.key(0)), seed=1)
    vp = realistic(jax.eval_shape(jv.init, jax.random.key(1)), seed=2)
    td, tv = DiT.tiny(device="cpu"), CausalVAE.tiny(device="cpu")
    td.load_state_dict(jax_params_to_torch(dp), strict=True)
    tv.load_state_dict(jax_params_to_torch(vp), strict=True)
    c = td.cfg
    pipe = BindYourAvatarPipeline.create(
        td.eval(), tv.eval(),
        PipelineConfig(height=c.sample_height * 8, width=c.sample_width * 8,
                       num_frames=c.sample_frames, num_inference_steps=STEPS))
    return jv, vp, pipe


def _request(pipe, seed, rid="", **kw):
    """A face + audio request drawn from `seed` (numpy)."""
    c, a, lf = pipe.dit.cfg, pipe.dit.audio_cfg, pipe.dit.lfe_cfg
    rng = np.random.default_rng(seed)
    f32 = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    return GenerationRequest(
        prompt_embeds=f32(1, c.max_text_seq_length, c.text_embed_dim),
        image=rng.uniform(-1, 1, (1, 1, 3, c.sample_height * 8, c.sample_width * 8)
                          ).astype(np.float32),
        id_cond=f32(1, c.num_ids, lf.id_embed_dim),
        id_vit_hidden=f32(1, c.num_ids, lf.num_scales, 6, lf.vit_dim),
        audio_embeds=f32(1, 2, c.sample_frames + a.window_size - a.window_stride, a.blocks,
                         a.audio_dim),
        seed=seed, request_id=rid, **kw)


def _generate(pipe, req: GenerationRequest, **kw):
    """`pipeline.generate` on a request's tensors (the server's staging)."""
    t = lambda x: None if x is None else torch.from_numpy(x)
    cond = dict(id_cond=t(req.id_cond), id_vit_hidden=t(req.id_vit_hidden),
                audio_embeds=t(req.audio_embeds))
    if req.forced_routing is not None:
        cond["routing_forcing"] = t(req.forced_routing)
    neg = torch.zeros_like(t(req.prompt_embeds))
    return pipe.generate(t(req.prompt_embeds), neg, t(req.image), **{**cond, **kw})


def _latents(pipe, n=LATENT_FRAMES, seed=0):
    """Latents of n frames on a 4 x 6 grid (the decode is shape-agnostic)."""
    return np.random.default_rng(seed).standard_normal(
        (1, n, pipe.vae.cfg.latent_channels, 4, 6)).astype(np.float32)


# ------------------------------------------------------------- decode_stream
@pytest.mark.parametrize("chunk", [2, 3])
def test_decode_stream_matches_jax(models, chunk):
    """The same start frames; each chunk within 1e-5 of the output's
    magnitude (one context frame, the first chunk chunk + 1 frames)."""
    jv, vp, pipe = models
    lat = _latents(pipe)
    want = list(jv.decode_stream(vp, jnp.asarray(lat), chunk))
    got = list(pipe.vae.decode_stream(torch.from_numpy(lat), chunk))
    assert [s for s, _ in got] == [int(s) for s, _ in want]
    assert len(got) == (3 if chunk == 2 else 2)
    scale = max(float(np.abs(np.asarray(c)).max()) for _, c in want)
    for (_, g), (_, w) in zip(got, want):
        assert g.shape == w.shape
        assert max_err(g, w) / scale < 1e-5


def test_chunked_decode_is_the_concatenated_stream(models):
    """`decode(temporal_chunk=k)` is the concatenation of `decode_stream`'s
    chunks bit for bit; without a chunk, or a chunk past the clip, the
    stream is one whole decode."""
    _, _, pipe = models
    lat = torch.from_numpy(_latents(pipe))
    for chunk in (2, 3):
        stream = torch.cat([c for _, c in pipe.vae.decode_stream(lat, chunk)], dim=1)
        assert torch.equal(pipe.vae.decode(lat, temporal_chunk=chunk), stream)
    whole = pipe.vae.decode(lat)
    assert whole.shape[1] == 4 * (LATENT_FRAMES - 1) + 1
    for chunk in (None, LATENT_FRAMES):
        (start, c), = list(pipe.vae.decode_stream(lat, chunk))
        assert start == 0 and torch.equal(c, whole)


def test_whole_decode_sliced_ops_match_jax(models, monkeypatch):
    """The whole decode (as `generate` runs it) against JAX's, with the
    sliced no-grad ops forced on (group norms by groups, causal convs and
    the spatial upsamples by frames, the spatial norm's modulation in
    place) and off: 1e-5 of the output's magnitude."""
    jv, vp, pipe = models
    lat = _latents(pipe, n=3)
    want = np.asarray(jv.decode(vp, jnp.asarray(lat)))
    scale = float(np.abs(want).max())
    one_pass = pipe.vae.decode(torch.from_numpy(lat))
    monkeypatch.setattr(tvae, "SLICE_ELEMENTS", 1500)
    sliced = pipe.vae.decode(torch.from_numpy(lat))
    for got in (one_pass, sliced):
        assert max_err(got, want) / scale < 1e-5


# -------------------------------------------------------------------- server
@pytest.fixture(scope="module")
def server(models):
    srv = InferenceServer(models[2], "cpu", batch_max=2, batch_wait_s=0.5)
    yield srv
    srv.close()


def test_forced_routing_through_the_server(models, server):
    """A request's `forced_routing` reaches `generate` as `routing_forcing`:
    the final latents equal a direct `generate` with the same seed and
    inputs bit for bit, and differ from the unforced ones."""
    pipe = models[2]
    c = pipe.dit.cfg
    force = (np.random.default_rng(5).uniform(0, 1, (1, c.video_seq_len, c.num_ids)) > 0.6
             ).astype(np.float32)
    req = _request(pipe, 11, "forced", forced_routing=force, decode=False)
    got = server.submit(req).result(timeout=300)
    gen = lambda: torch.Generator().manual_seed(11)
    want = _generate(pipe, req, generator=gen(), decode=False)
    assert np.array_equal(got.video, want.numpy())
    free = _generate(pipe, _request(pipe, 11), generator=gen(), decode=False)
    assert not np.array_equal(got.video, free.numpy())
    assert got.timings["batch_size"] == 1.0
    assert {"prep_s", "encode_s", "denoise_s", "compute_s"} <= set(got.timings)


def test_batch_of_two_is_one_stacked_generate(models, server, monkeypatch):
    """Two co-batchable requests run as ONE `generate` on the stacked
    inputs: each request's initial latents are its own generator's first
    draw, the SDE noise continues the first request's generator; the
    latents equal a direct `generate` so fed, bit for bit.  Then a
    decoding pair: each clip decoded alone equals the whole decode of its
    latents."""
    pipe = models[2]
    calls = []
    real = pipe.generate
    monkeypatch.setattr(pipe, "generate", lambda *a, **kw: calls.append(a[0].shape[0])
                        or real(*a, **kw))
    reqs = [_request(pipe, 21 + i, f"b{i}", decode=False) for i in range(2)]
    futs = [server.submit(r) for r in reqs]
    got = [f.result(timeout=300) for f in futs]
    assert calls == [2]
    assert all(r.timings["batch_size"] == 2.0 for r in got)
    assert [r.request_id for r in got] == ["b0", "b1"]

    gens = [torch.Generator().manual_seed(r.seed) for r in reqs]
    shape = (1, pipe.dit.cfg.latent_frames, pipe.vae.cfg.latent_channels,
             pipe.dit.cfg.sample_height, pipe.dit.cfg.sample_width)
    lat = torch.cat([torch.randn(shape, generator=g) for g in gens])
    stacked = {k: np.concatenate([getattr(r, k) for r in reqs]) for k in (
        "prompt_embeds", "image", "id_cond", "id_vit_hidden", "audio_embeds")}
    want = _generate(pipe, GenerationRequest(**stacked), generator=gens[0], latents=lat,
                     decode=False)
    for i, r in enumerate(got):
        assert np.array_equal(r.video, want[i:i + 1].numpy())

    calls.clear()
    futs = [server.submit(_request(pipe, 21 + i, f"v{i}")) for i in range(2)]
    videos = [f.result(timeout=300) for f in futs]
    assert calls == [2] and videos[0].timings["batch_size"] == 2.0
    for i, r in enumerate(videos):
        assert r.video.shape == (1, pipe.cfg.num_frames, 3, pipe.cfg.height, pipe.cfg.width)
        assert np.array_equal(r.video, pipe.vae.decode(want[i:i + 1]).numpy())


def test_streamed_request_chunks_equal_its_decode(models, server):
    """`stream_chunk_frames=1`: `on_chunk` fires per chunk in order from
    frame 0, the result is the concatenated chunks, and they equal
    `decode(temporal_chunk=1)` of the same request's latents bit for bit."""
    pipe = models[2]
    lat = server.submit(_request(pipe, 31, decode=False)).result(timeout=300).video
    chunks = []
    req = _request(pipe, 31, "s", stream_chunk_frames=1,
                   on_chunk=lambda start, arr: chunks.append((start, arr)))
    res = server.submit(req).result(timeout=300)
    starts = [s for s, _ in chunks]
    assert len(chunks) == pipe.dit.cfg.latent_frames - 1
    assert starts == [0] + list(np.cumsum([a.shape[1] for _, a in chunks[:-1]]))
    video = np.concatenate([a for _, a in chunks], axis=1)
    assert np.array_equal(res.video, video)
    assert np.array_equal(video, pipe.vae.decode(torch.from_numpy(lat), temporal_chunk=1).numpy())


def test_close_fails_the_queued_futures():
    """close() with one request running and three queued: the running one
    finishes, every queued future fails with 'server closed', and a submit
    after close raises."""
    release, started = threading.Event(), threading.Event()

    def generate(pe, *a, **kw):
        started.set()
        release.wait(timeout=60)
        return torch.zeros(1, 1)

    cfg = types.SimpleNamespace(is_train_face=False, is_train_audio=False)
    pipe = types.SimpleNamespace(dit=types.SimpleNamespace(cfg=cfg), generate=generate)
    srv = InferenceServer(pipe, "cpu")
    req = lambda i: GenerationRequest(prompt_embeds=np.zeros((1, 2, 3), np.float32),
                                      image=np.zeros((1, 1, 3, 8, 8), np.float32),
                                      request_id=f"q{i}")
    futs = [srv.submit(req(0))]
    assert started.wait(timeout=60)
    futs += [srv.submit(req(i)) for i in (1, 2, 3)]
    # the running request ends once close() has failed the two staged ones
    threading.Thread(target=lambda: (wait(futs[1:3], timeout=60), release.set())).start()
    srv.close()
    assert futs[0].result(timeout=0).request_id == "q0"
    for f in futs[1:]:
        with pytest.raises(RuntimeError, match="server closed"):
            f.result(timeout=0)
    with pytest.raises(RuntimeError, match="server closed"):
        srv.submit(req(4))
    assert not srv._compute_thread.is_alive() and not srv._prep_thread.is_alive()


# ---------------------------------------------------------------------- HTTP
def _post(port, spec):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/generate",
                                 data=json.dumps(spec).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=300)


def _spec(req, directory, **kw):
    """The request's arrays as .npy files in `directory`: the HTTP body."""
    spec = {"seed": req.seed, "request_id": req.request_id, **kw}
    for f in ("prompt_embeds", "image", "id_cond", "id_vit_hidden", "audio_embeds"):
        np.save(directory / f"{f}.npy", getattr(req, f))
        spec[f] = str(directory / f"{f}.npy")
    return spec


def test_serve_http(models, server, tmp_path):
    """GET /healthz; POST /generate -> the clip saved as .npy (equal to the
    same request submitted directly); the NDJSON streaming reply, one
    `<output>.chunkNNN.npy` per chunk and a final done line; a 404."""
    pipe = models[2]
    httpd = serve_http(server, port=0, block=False)
    port = httpd.server_address[1]
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["ok"] is True and health["served"] == server.requests_served
        req = _request(pipe, 41, "h0")
        with _post(port, _spec(req, tmp_path, output=str(tmp_path / "out.npy"))) as r:
            out = json.loads(r.read())
        assert out["request_id"] == "h0" and out["timings"]["batch_size"] == 1.0
        direct = server.submit(_request(pipe, 41)).result(timeout=300).video
        assert np.array_equal(np.load(out["output"]), direct)

        spec = _spec(_request(pipe, 41, "h1"), tmp_path, stream_chunk_frames=1,
                     output=str(tmp_path / "stream.npy"))
        with _post(port, spec) as r:
            assert r.headers.get("Content-Type") == "application/x-ndjson"
            lines = [json.loads(ln) for ln in r.read().decode().splitlines()]
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/nothing", timeout=30)
        assert e.value.code == 404
    finally:
        httpd.shutdown()
    done, chunk_lines = lines[-1], lines[:-1]
    assert done["done"] is True and done["request_id"] == "h1"
    assert done["chunks"] == len(chunk_lines) == pipe.dit.cfg.latent_frames - 1
    assert [ln["path"] for ln in chunk_lines] == [
        str(tmp_path / f"stream.npy.chunk{i:03d}.npy") for i in range(len(chunk_lines))]
    assert [ln["start_frame"] for ln in chunk_lines] == list(
        np.cumsum([0] + [ln["frames"] for ln in chunk_lines[:-1]]))
    video = np.concatenate([np.load(ln["path"]) for ln in chunk_lines], axis=1)
    streamed = server.submit(_request(pipe, 41, stream_chunk_frames=1)).result(timeout=300)
    assert np.array_equal(video, streamed.video)


def test_serve_http_data_root_refuses_escapes(models, server, tmp_path):
    """With `data_root`, a request path outside it (inputs or output) is
    refused with a 500 naming the escape; paths inside it are served."""
    pipe = models[2]
    root = tmp_path / "root"
    root.mkdir()
    httpd = serve_http(server, port=0, block=False, data_root=str(root))
    port = httpd.server_address[1]
    try:
        spec = _spec(_request(pipe, 51, "d0"), root)
        spec = {k: (v.replace(str(root) + "/", "") if isinstance(v, str) else v)
                for k, v in spec.items()}
        for bad in ({"prompt_embeds": "../x.npy"}, {"output": "../../out.npy"},
                    {"image": "/etc/hostname"}):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(port, {**spec, **bad})
            assert e.value.code == 500
            assert "escapes data_root" in json.loads(e.value.read())["error"]
        with _post(port, {**spec, "output": "inside.npy"}) as r:
            out = json.loads(r.read())
        assert out["output"] == str((root / "inside.npy").resolve())
        assert (root / "inside.npy").is_file()
    finally:
        httpd.shutdown()

"""The fully conditioned (face + audio) serving slice on the CPU: tiny DiT
with the face path on (the JAX `DiT.tiny` shapes) + tiny VAE.

`DiT.apply` and a 2-step DPM++ `pipeline.generate` of the port against the
JAX package on the same weights (realistic scale), the same initial latents
and the same per-step SDE noise; and face + audio requests through the
port's `InferenceServer`.  fp32 on both sides: 1e-5 relative to the
output's magnitude for outputs and latents, 1e-5 absolute for the routing
(values in [0, 1]).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bindyouravatar_tpu.config import PipelineConfig as JPipelineConfig
from bindyouravatar_tpu.config import VAEConfig as JVAEConfig
from bindyouravatar_tpu.models.dit import DiT as JDiT
from bindyouravatar_tpu.models.vae import CausalVAE as JCausalVAE
from bindyouravatar_tpu.pipeline.pipeline import BindYourAvatarPipeline as JPipeline
from bindyouravatar_tpu.pipeline.pipeline import temporal_or_routing as jtemporal_or_routing
from bindyouravatar_tpu_torch.config import PipelineConfig
from bindyouravatar_tpu_torch.convert import jax_params_to_torch
from bindyouravatar_tpu_torch.models.dit import DiT
from bindyouravatar_tpu_torch.models.vae import CausalVAE
from bindyouravatar_tpu_torch.pipeline.pipeline import BindYourAvatarPipeline, temporal_or_routing
from bindyouravatar_tpu_torch.serving import GenerationRequest, InferenceServer
from torch_port_utils import max_err, realistic, to_torch

STEPS = 2


def _rel(got, want) -> float:
    return max_err(got, want) / float(np.abs(np.asarray(want)).max())


@pytest.fixture(scope="module")
def models():
    """(JAX dit, vae, params) and the port's modules on the same weights."""
    jd = JDiT.tiny()
    jv = JCausalVAE(JVAEConfig(block_out_channels=(8, 8, 16, 16), layers_per_block=1,
                               latent_channels=4, norm_num_groups=4, dtype=jnp.float32))
    dp = realistic(jax.eval_shape(jd.init, jax.random.key(0)), seed=1)
    vp = realistic(jax.eval_shape(jv.init, jax.random.key(1)), seed=2)
    td, tv = DiT.tiny(device="cpu"), CausalVAE.tiny(device="cpu")
    td.load_state_dict(jax_params_to_torch(dp), strict=True)
    tv.load_state_dict(jax_params_to_torch(vp), strict=True)
    return jd, jv, dp, vp, td.eval(), tv.eval()


def _cond(jd, rng, b, face=True, audio=True):
    """Numpy conditioning for batch b: face (ArcFace + CLIP id embedding, 5
    ViT scales of 6 tokens) and two audio tracks."""
    c, a, lf = jd.cfg, jd.audio_cfg, jd.lfe_cfg
    out = {}
    if face:
        out["id_cond"] = rng.standard_normal((b, c.num_ids, lf.id_embed_dim)).astype(np.float32)
        out["id_vit_hidden"] = rng.standard_normal(
            (b, c.num_ids, lf.num_scales, 6, lf.vit_dim)).astype(np.float32)
    if audio:
        n_af = c.sample_frames + a.window_size - a.window_stride
        out["audio_embeds"] = rng.standard_normal(
            (b, 2, n_af, a.blocks, a.audio_dim)).astype(np.float32)
    return out


@pytest.mark.parametrize("case", ["face+audio", "face", "face+audio override", "audio only"])
def test_face_dit_apply_matches(models, case):
    """One fully conditioned forward (batch-2 CFG shapes) against JAX
    `DiT.apply`: block -> face injection -> audio in each layer, the audio
    weights from the last injection's routing (or from the override); the
    routing predictions [num_ca, B, S, I] are returned either way.  Given
    no face tokens the face-configured DiT keeps the uniform 0.5."""
    jd, _, dp, _, td, _ = models
    c = jd.cfg
    rng = np.random.default_rng(3)
    lat = rng.standard_normal((2, c.latent_frames, c.in_channels, c.sample_height,
                               c.sample_width)).astype(np.float32)
    txt = rng.standard_normal((2, c.max_text_seq_length, c.text_embed_dim)).astype(np.float32)
    ts = np.array([999.0, 499.0], np.float32)
    cond = _cond(jd, rng, 2, face=case != "audio only", audio="audio" in case)
    if "override" in case:
        cond["routing_override"] = rng.uniform(0, 1, (2, c.video_seq_len, c.num_ids)).astype(
            np.float32)
    rope = jd.rope(c.sample_height * 8, c.sample_width * 8, c.latent_frames)
    want, want_r = jd.apply(dp, jnp.asarray(lat), jnp.asarray(txt), jnp.asarray(ts), rope,
                            **{k: jnp.asarray(v) for k, v in cond.items()})
    with torch.no_grad():
        got, got_r = td.apply(*to_torch(lat, txt, ts), tuple(to_torch(*rope)),
                              **{k: to_torch(v)[0] for k, v in cond.items()})
    assert _rel(got, want) < 1e-5
    if case == "audio only":
        assert got_r is None and want_r is None
    else:
        assert got_r.shape == (c.num_ca, 2, c.video_seq_len, c.num_ids) == want_r.shape
        assert max_err(got_r, want_r) < 1e-5


def test_prepare_conditioning_face_tokens_match(models):
    """The once-per-clip face tokens (LFE over batch x identity)."""
    jd, _, dp, _, td, _ = models
    cond = _cond(jd, np.random.default_rng(4), 2, audio=False)
    want, _ = jd.prepare_conditioning(dp, **{k: jnp.asarray(v) for k, v in cond.items()})
    with torch.no_grad():
        got, actx = td.prepare_conditioning(**{k: to_torch(v)[0] for k, v in cond.items()})
    assert actx is None
    assert got.shape == (2, jd.cfg.num_ids, jd.cfg.lfe_num_tokens, jd.cfg.lfe_final_output_dim)
    assert _rel(got, want) < 1e-5


def test_temporal_or_routing_matches(models):
    jd = models[0]
    grid = jd.cfg.latent_grid
    r = np.random.default_rng(5).uniform(0, 1, (2, int(np.prod(grid)), 2)).astype(np.float32)
    got = temporal_or_routing(torch.from_numpy(r), grid)
    assert max_err(got, jtemporal_or_routing(jnp.asarray(r), grid)) == 0.0


@pytest.mark.parametrize("grid", ["config", "other t, same tokens", "other h*w"])
def test_forced_routing_is_reduced_on_the_config_grid(models, grid):
    """A forced routing is OR-reduced over time on the DiT config's
    `latent_grid`, as JAX does; latents with another (t, h*w) raise, where
    JAX's reshape fails or, at the same token count, mixes frames."""
    jd, _, _, _, td, tv = models
    c = jd.cfg
    t, h, w = c.latent_grid
    p = c.patch_size
    lat_t, lat_h, lat_w = c.latent_frames, c.sample_height, c.sample_width
    if grid == "other t, same tokens":           # one frame of t times the rows
        lat_t, lat_h = 1, t * lat_h
    elif grid == "other h*w":
        lat_h += p
    n_tok = lat_t * (lat_h // p) * (lat_w // p)
    rng = np.random.default_rng(8)
    force = (rng.uniform(0, 1, (1, n_tok, c.num_ids)) > 0.7).astype(np.float32)
    tp = BindYourAvatarPipeline.create(td, tv, PipelineConfig())
    kw = dict(generator=torch.Generator().manual_seed(0), routing_forcing=torch.from_numpy(force))
    prompt = torch.zeros(1, c.max_text_seq_length, c.text_embed_dim)
    image_lat = torch.zeros(1, lat_t, 4, lat_h, lat_w)
    if grid != "config":
        with pytest.raises(ValueError, match="latent grid"):
            tp.prepare_denoise_inputs(prompt, image_lat, STEPS, **kw)
        return
    with torch.no_grad():
        got = tp.prepare_denoise_inputs(prompt, image_lat, STEPS, **kw)["force"]
    want = jtemporal_or_routing(jnp.concatenate([jnp.asarray(force)] * 2, axis=0), (t, h, w))
    assert got.shape == (2, n_tok, c.num_ids)
    assert max_err(got, want) == 0.0


@pytest.mark.parametrize("options", [{}, dict(zero2cond_cfg=True, forcing=True)])
def test_generate_face_matches_jax_pipeline(models, options):
    """2 DPM++ steps, face + audio, batch-2 CFG; with zero2cond the uncond
    half sees zeroed face inputs, and the forced routing replaces the
    predicted one (OR-reduced over time first)."""
    jd, jv, dp, vp, td, tv = models
    c = jd.cfg
    options = dict(options)
    forcing = options.pop("forcing", False)
    kw = dict(height=c.sample_height * 8, width=c.sample_width * 8,
              num_frames=c.sample_frames, num_inference_steps=STEPS, **options)
    jp = JPipeline.create(jd, jv, JPipelineConfig(**kw))
    tp = BindYourAvatarPipeline.create(td, tv, PipelineConfig(**kw))
    rng = np.random.default_rng(6)
    prompt = rng.standard_normal((1, c.max_text_seq_length, c.text_embed_dim)).astype(np.float32)
    image = rng.uniform(-1, 1, (1, 1, 3, c.sample_height * 8,
                                c.sample_width * 8)).astype(np.float32)
    latents = rng.standard_normal((1, c.latent_frames, 4, c.sample_height,
                                   c.sample_width)).astype(np.float32)
    cond = _cond(jd, rng, 1)
    if forcing:
        cond["routing_forcing"] = (rng.uniform(0, 1, (1, c.video_seq_len, c.num_ids)) > 0.7
                                   ).astype(np.float32)
    neg = np.zeros_like(prompt)
    key = jax.random.key(7)
    jlat = jp.generate({"dit": dp, "vae": vp}, jnp.asarray(prompt), jnp.asarray(neg),
                       jnp.asarray(image), key, decode=False, latents=jnp.asarray(latents),
                       **{k: jnp.asarray(v) for k, v in cond.items()})
    # the JAX loop's SDE noise: key -> (carry, init) split, then one split per step
    k, noise = jax.random.split(key)[0], []
    for _ in range(STEPS):
        k, k_noise = jax.random.split(k)
        noise.append(torch.from_numpy(np.array(jax.random.normal(k_noise, latents.shape))))
    tlat = tp.generate(*to_torch(prompt, neg, image), torch.Generator().manual_seed(0),
                       decode=False, latents=torch.from_numpy(latents), noise=noise,
                       **{k: to_torch(v)[0] for k, v in cond.items()})
    assert _rel(tlat, jlat) < 1e-5


def test_server_answers_face_and_audio_requests(models):
    """Two face + audio requests and one audio-only request on the same
    face-configured model, decoded to video."""
    jd, _, _, _, td, tv = models
    c = jd.cfg
    pipe = BindYourAvatarPipeline.create(
        td, tv, PipelineConfig(height=c.sample_height * 8, width=c.sample_width * 8,
                               num_frames=c.sample_frames, num_inference_steps=STEPS))
    server = InferenceServer(pipe, "cpu")
    try:
        reqs = []
        for i, face in enumerate((True, True, False)):
            rng = np.random.default_rng(20 + i)
            reqs.append(GenerationRequest(
                prompt_embeds=rng.standard_normal(
                    (1, c.max_text_seq_length, c.text_embed_dim)).astype(np.float32),
                image=rng.uniform(-1, 1, (1, 1, 3, c.sample_height * 8,
                                          c.sample_width * 8)).astype(np.float32),
                seed=i, request_id=f"r{i}", **_cond(jd, rng, 1, face=face)))
        results = [f.result(timeout=300) for f in [server.submit(r) for r in reqs]]
    finally:
        server.close()
    for i, r in enumerate(results):
        assert r.request_id == f"r{i}"
        assert r.video.shape == (1, c.sample_frames, 3, c.sample_height * 8, c.sample_width * 8)
        assert np.isfinite(r.video).all()
    assert server.requests_served == 3

"""The serving slice as a whole on the CPU: tiny audio-only DiT + tiny VAE.

`pipeline.generate` of the port against the JAX pipeline at 2 DPM++ steps on
the same weights (realistic scale), the same initial latents and the same
per-step SDE noise (the JAX loop's own draws, handed over as arrays); and two
requests through the port's `InferenceServer`.  fp32 on both sides: the
tolerances cover summation order, amplified by the VAE decoder (1e-4
relative to the output's magnitude; 1e-5 for latents and one DiT step).
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
from bindyouravatar_tpu_torch.config import PipelineConfig
from bindyouravatar_tpu_torch.convert import jax_params_to_torch
from bindyouravatar_tpu_torch.models.dit import DiT
from bindyouravatar_tpu_torch.models.vae import CausalVAE
from bindyouravatar_tpu_torch.pipeline.pipeline import BindYourAvatarPipeline
from bindyouravatar_tpu_torch.serving import GenerationRequest, InferenceServer
from torch_port_utils import max_err, realistic, to_torch

STEPS = 2


def _rel(got, want) -> float:
    return max_err(got, want) / float(np.abs(np.asarray(want)).max())


@pytest.fixture(scope="module")
def models():
    """(JAX dit, vae, params) and the port's modules on the same weights."""
    jd = JDiT.tiny(is_train_face=False)
    jv = JCausalVAE(JVAEConfig(block_out_channels=(8, 8, 16, 16), layers_per_block=1,
                               latent_channels=4, norm_num_groups=4, dtype=jnp.float32))
    dp = realistic(jax.eval_shape(jd.init, jax.random.key(0)), seed=1)
    vp = realistic(jax.eval_shape(jv.init, jax.random.key(1)), seed=2)
    td = DiT.tiny(device="cpu", is_train_face=False)
    tv = CausalVAE.tiny(device="cpu")
    td.load_state_dict(jax_params_to_torch(dp), strict=True)
    tv.load_state_dict(jax_params_to_torch(vp), strict=True)
    return jd, jv, dp, vp, td.eval(), tv.eval()


def _inputs(jd, seed):
    c, a = jd.cfg, jd.audio_cfg
    rng = np.random.default_rng(seed)
    n_af = c.sample_frames + a.window_size - a.window_stride
    return dict(
        prompt=rng.standard_normal((1, c.max_text_seq_length, c.text_embed_dim)).astype(np.float32),
        image=rng.uniform(-1, 1, (1, 1, 3, c.sample_height * 8, c.sample_width * 8)).astype(np.float32),
        audio=rng.standard_normal((1, 2, n_af, a.blocks, a.audio_dim)).astype(np.float32),
        latents=rng.standard_normal((1, c.latent_frames, 4, c.sample_height,
                                     c.sample_width)).astype(np.float32))


@pytest.mark.parametrize("audio", [True, False])
def test_dit_apply_matches(models, audio):
    """One denoise forward of the audio-only and the bare DiT (batch-2 CFG
    shapes) against JAX `DiT.apply`."""
    jd, _, dp, _, td, _ = models
    c = jd.cfg
    rng = np.random.default_rng(3)
    lat = rng.standard_normal((2, c.latent_frames, c.in_channels, c.sample_height,
                               c.sample_width)).astype(np.float32)
    txt = rng.standard_normal((2, c.max_text_seq_length, c.text_embed_dim)).astype(np.float32)
    ts = np.array([999.0, 499.0], np.float32)
    cond = {}
    if audio:
        a = jd.audio_cfg
        n_af = c.sample_frames + a.window_size - a.window_stride
        cond["audio_embeds"] = rng.standard_normal((2, 2, n_af, a.blocks,
                                                    a.audio_dim)).astype(np.float32)
    rope = jd.rope(c.sample_height * 8, c.sample_width * 8, c.latent_frames)
    want, _ = jd.apply(dp, jnp.asarray(lat), jnp.asarray(txt), jnp.asarray(ts), rope,
                       **{k: jnp.asarray(v) for k, v in cond.items()})
    with torch.no_grad():
        got, routing = td.apply(*to_torch(lat, txt, ts), tuple(to_torch(*rope)),
                                **{k: to_torch(v)[0] for k, v in cond.items()})
    assert routing is None
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("options", [
    {},                                                       # DPM++, batch-2 CFG
    dict(scheduler_type="ddim", use_dynamic_cfg=True, zero2cond_cfg=True),
])
def test_generate_matches_jax_pipeline(models, options):
    jd, jv, dp, vp, td, tv = models
    c = jd.cfg
    kw = dict(height=c.sample_height * 8, width=c.sample_width * 8,
              num_frames=c.sample_frames, num_inference_steps=STEPS, **options)
    jp = JPipeline.create(jd, jv, JPipelineConfig(**kw))
    tp = BindYourAvatarPipeline.create(td, tv, PipelineConfig(**kw))
    x = _inputs(jd, seed=4)
    neg = np.zeros_like(x["prompt"])
    key = jax.random.key(5)
    jargs = (jnp.asarray(x["prompt"]), jnp.asarray(neg), jnp.asarray(x["image"]), key)
    jlat = jp.generate({"dit": dp, "vae": vp}, *jargs, decode=False,
                       latents=jnp.asarray(x["latents"]), audio_embeds=jnp.asarray(x["audio"]))
    jvid = jv.decode(vp, jlat)
    # the JAX loop's SDE noise: key -> (carry, init) split, then one split per step
    k, noise = jax.random.split(key)[0], []
    for _ in range(STEPS):
        k, k_noise = jax.random.split(k)
        noise.append(torch.from_numpy(np.array(jax.random.normal(k_noise, x["latents"].shape))))
    targs = (*to_torch(x["prompt"], neg, x["image"]), torch.Generator().manual_seed(0))
    tkw = dict(latents=torch.from_numpy(x["latents"]), noise=noise,
               audio_embeds=torch.from_numpy(x["audio"]))
    timings = {}
    tlat = tp.generate(*targs, decode=False, **tkw)
    tvid = tp.generate(*targs, timings=timings, **tkw)
    assert set(timings) == {"encode_s", "denoise_s", "decode_s"}
    assert _rel(tlat, jlat) < 1e-5
    assert tvid.shape == (1, c.sample_frames, 3, c.sample_height * 8, c.sample_width * 8)
    assert _rel(tvid, jvid) < 1e-4


@pytest.mark.parametrize("scheduler", ["dpm", "ddim"])
def test_cfg_microbatch_equals_batched_cfg(models, scheduler):
    """Two sequential batch-1 CFG halves == one batch-2 forward (same math,
    half the activations); tol 1e-5 relative (fp32 row-blocking order)."""
    jd, _, _, _, td, tv = models
    c = jd.cfg
    x = _inputs(jd, seed=6)
    outs = []
    for micro in (False, True):
        pipe = BindYourAvatarPipeline.create(td, tv, PipelineConfig(
            height=c.sample_height * 8, width=c.sample_width * 8, num_frames=c.sample_frames,
            num_inference_steps=STEPS, scheduler_type=scheduler, cfg_microbatch=micro))
        outs.append(pipe.generate(*to_torch(x["prompt"], np.zeros_like(x["prompt"]), x["image"]),
                                  torch.Generator().manual_seed(7), decode=False,
                                  latents=torch.from_numpy(x["latents"]),
                                  audio_embeds=torch.from_numpy(x["audio"])))
    assert _rel(outs[1], outs[0].numpy()) < 1e-5


def test_server_answers_two_requests(models):
    jd, _, _, _, td, tv = models
    c = jd.cfg
    pipe = BindYourAvatarPipeline.create(
        td, tv, PipelineConfig(height=c.sample_height * 8, width=c.sample_width * 8,
                               num_frames=c.sample_frames, num_inference_steps=STEPS))
    server = InferenceServer(pipe, "cpu")
    try:
        reqs = []
        for i, seed in enumerate((0, 1, 0)):
            x = _inputs(jd, seed=10 + seed)
            reqs.append(GenerationRequest(prompt_embeds=x["prompt"], image=x["image"],
                                          audio_embeds=x["audio"], seed=seed,
                                          request_id=f"r{i}"))
        results = [f.result(timeout=300) for f in [server.submit(r) for r in reqs]]
    finally:
        server.close()
    for i, r in enumerate(results):
        assert r.request_id == f"r{i}"
        assert r.video.shape == (1, c.sample_frames, 3, c.sample_height * 8, c.sample_width * 8)
        assert np.isfinite(r.video).all()
        assert {"prep_s", "encode_s", "denoise_s", "decode_s", "compute_s"} <= set(r.timings)
    np.testing.assert_array_equal(results[0].video, results[2].video)   # same seed
    assert np.abs(results[0].video - results[1].video).max() > 1e-3
    assert server.requests_served == 3
    with pytest.raises(RuntimeError, match="closed"):
        server.submit(reqs[0])

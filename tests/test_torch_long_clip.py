"""Long clips on the CPU: the router's temporal attention past 16 latent
frames (81 and 97 pixel frames: T = 21 and 25) against the JAX package.

Kernels B5, B5' and B8 take every S up to `packed_attention.MAX_S` on the
card on the long bodies of `csrc/packed_attention.cu`, and every S past it
on the streamed body (`chip_smoke.py` phase 2 holds them against their
plain versions there, phase 12 drives them in the 5B model;
`tests/test_torch_any_length.py` holds the lengths past the caps here).
Here: their plain versions, which a CPU tensor takes, against the Pallas
bodies they replace, run in interpret mode, at S = 17, 25, 33 and 64; the
shape rule that picks a body (`kernel_body`); the
router (norms, one layer's projections, the trunk with its STABs) at T =
25, forward and every input and parameter gradient against `jax.vjp`; the
tiny face + audio `DiT.apply` and a 2-step `generate` with
`return_routing` at 97 frames against JAX's on the same weights (JAX's
side runs once, in the module fixture `jax_run`); the tiny CLI at
`--num_frames 97` from two face images.  fp32 on both sides: 1e-5 relative
to an output's magnitude, 1e-4 for gradients (more sums in another order),
the routing of `generate` within one bf16 ulp at 1.0 (2^-8), as the face
slice's and the CLI's files hold them.
"""

import functools
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from bindyouravatar_tpu.config import PipelineConfig as JPipelineConfig
from bindyouravatar_tpu.config import RouterConfig as JRouterConfig
from bindyouravatar_tpu.config import VAEConfig as JVAEConfig
from bindyouravatar_tpu.models import router as jrouter
from bindyouravatar_tpu.models.dit import DiT as JDiT
from bindyouravatar_tpu.models.vae import CausalVAE as JCausalVAE
from bindyouravatar_tpu.ops import packed_attention as jpa
from bindyouravatar_tpu.pipeline.pipeline import BindYourAvatarPipeline as JPipeline
from bindyouravatar_tpu_torch import infer
from bindyouravatar_tpu_torch.config import PipelineConfig, RouterConfig
from bindyouravatar_tpu_torch.convert import jax_params_to_torch
from bindyouravatar_tpu_torch.models import router as trouter
from bindyouravatar_tpu_torch.models.dit import DiT
from bindyouravatar_tpu_torch.models.vae import CausalVAE
from bindyouravatar_tpu_torch.ops import packed_attention as tpa
from bindyouravatar_tpu_torch.pipeline.pipeline import BindYourAvatarPipeline
from torch_port_utils import max_err, realistic, threads_per_worker, to_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(ROOT, "assets")
FRAMES = 97                     # T = (97 - 1) / 4 + 1 = 25 latent frames
STEPS = 2
F32 = dict(compute_dtype=torch.float32, dtype=torch.float32)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    with threads_per_worker():
        yield


def _rel(got, want) -> float:
    return max_err(got, want) / float(np.abs(np.asarray(want)).max())


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ----------------------------------------------------- B5, B5' past 16 rows
@pytest.mark.parametrize("s", [17, 25, 33, 64])
def test_b5_plain_matches_slice_kernel_interpret(s):
    """B5's plain version vs `_slice_kernel` (interpret), 2 heads of 64
    over 16 rows in blocks of 8."""
    m, heads, dh = 16, 2, 64
    rng = np.random.default_rng(190 + s)
    q, k, v = (_normal(rng, m, s, heads * dh) for _ in range(3))
    spec = pl.BlockSpec((8, s, heads * dh), lambda i: (i, 0, 0))
    want = pl.pallas_call(
        functools.partial(jpa._slice_kernel, heads=heads, sm_scale=dh ** -0.5),
        grid=(m // 8,), in_specs=[spec, spec, spec], out_specs=spec,
        out_shape=jax.ShapeDtypeStruct((m, s, heads * dh), jnp.float32),
        interpret=True)(*map(jnp.asarray, (q, k, v)))
    assert _rel(tpa.tiny_seq_attention(*to_torch(q, k, v), heads, dh ** -0.5), want) < 1e-5


@pytest.mark.parametrize("s", [17, 25, 33, 64])
def test_b5p_plain_matches_packed_kernel_interpret(s):
    """B5''s plain version (the packed fold) vs `_kernel` (interpret) on
    the [M, S*H, 64] view."""
    m, heads, dh = 16, 2, 64
    rng = np.random.default_rng(290 + s)
    q, k, v = (_normal(rng, m, s * heads, dh) for _ in range(3))
    spec = pl.BlockSpec((8, s * heads, dh), lambda i: (i, 0, 0))
    want = pl.pallas_call(
        functools.partial(jpa._kernel, heads=heads, sm_scale=dh ** -0.5),
        grid=(m // 8,), in_specs=[spec, spec, spec], out_specs=spec,
        out_shape=jax.ShapeDtypeStruct((m, s * heads, dh), jnp.float32),
        interpret=True)(*map(jnp.asarray, (q, k, v)))
    assert _rel(tpa.packed_head_attention(*to_torch(q, k, v), heads, dh ** -0.5), want) < 1e-5


# ---------------------------------------------------------------- dispatch
@pytest.mark.parametrize("s", [17, 21, 25, 33, 64, 129])
def test_kernel_rule_takes_long_sequences(s):
    """A CUDA call at S past 16 (21 and 25 at 81 and 97 frames) launches
    the long body, forward (B5, B5') and backward (B8), at dh 64."""
    assert tpa.kernel_body(s, 8 * 64, 8) == "long"
    assert tpa.kernel_body(s, 8 * 64, 8, backward=True) == "long"
    assert tpa.kernel_body(s, 2 * 64, 2) == "long"


def test_kernel_rule_bodies_and_refusals():
    """The rest of the rule: B5' packs below 8, one tile an item up to 16,
    B8 from 8; a head of dh columns rides the narrowest body that holds it
    (64, 128 or 256 columns) and takes S up to that body's cap in `MAX_S`
    (the source's `Geo::LONG_MAX_S`) on the long body, 25 (97 frames) at
    every width, and past the cap on the streamed body; S below 1 (B8: 8),
    dh % 8 != 0 and dh > 256 raise, naming the ROADMAP item that holds
    them."""
    assert [tpa.kernel_body(s, 512, 8) for s in range(1, 17)] == ["packed"] * 7 + ["tile"] * 9
    assert [tpa.kernel_body(s, 512, 8, backward=True) for s in range(8, 17)] == ["tile"] * 9
    src = open(os.path.join(ROOT, "bindyouravatar_tpu_torch", "csrc", "packed_attention.cu")).read()
    caps = re.search(r"Geo<64>::LONG_MAX_S == (\d+) && Geo<128>::LONG_MAX_S == (\d+) &&\s*"
                     r"Geo<256>::LONG_MAX_S == (\d+)", src)
    assert dict(zip((64, 128, 256), map(int, caps.groups()))) == tpa.MAX_S
    for dh, cols in ((8, 64), (32, 64), (48, 64), (64, 64), (80, 128), (128, 128), (136, 256),
                     (256, 256)):
        assert tpa.body_columns(dh) == cols
        cap = tpa.MAX_S[cols]
        assert tpa.kernel_body(cap, 8 * dh, 8, backward=True) == "long"
        assert tpa.kernel_body(25, 4 * dh, 4, backward=True) == "long"
        for backward in (False, True):
            assert tpa.kernel_body(cap + 1, 8 * dh, 8, backward) == "stream"
    for backward in (False, True):
        assert tpa.kernel_body(tpa.MAX_S[64] + 1, 512, 8, backward) == "stream"
    for s, width, heads, backward in ((7, 512, 8, True), (0, 512, 8, False),
                                      (13, 96, 8, False), (13, 8 * 264, 8, True)):
        with pytest.raises(ValueError, match="B5|B8"):
            tpa.kernel_body(s, width, heads, backward)
    with pytest.raises(ValueError, match="ROADMAP.md queue B item 3"):
        tpa.kernel_body(13, 8 * 12, 8)
    with pytest.raises(ValueError, match="ROADMAP.md queue B item 4"):
        tpa.kernel_body(13, 2 * 264, 2)


# ---------------------------------------------------------------- router
def test_router_at_25_latent_frames_forward_and_vjp():
    """Shared norms -> one layer's projections -> the trunk (2 STABs, whose
    temporal attention runs over T = 25) on a (25, 2, 3) grid: the routing
    and, for one cotangent, the gradients of both inputs and of every
    parameter of the three modules, against `jax.vjp` of JAX's."""
    tiny = dict(num_id_token=8, num_heads=4, num_layers=2, q_k_dim=64, num_attention_layers=2,
                attn_heads=4)
    rcfg = JRouterConfig(**tiny)
    grid, b, n_id, qk = (25, 2, 3), 2, 2, rcfg.q_k_dim
    s = int(np.prod(grid))
    rng = np.random.default_rng(250)
    q_flat, k_flat = _normal(rng, b, s, qk), _normal(rng, b, n_id, rcfg.num_id_token, qk)
    cot = _normal(rng, b, s, n_id)
    jn = jrouter.RouterNorms(q_k_dim=qk)
    jl = jrouter.MultiIPRouterLayerProj(q_k_dim=qk, dtype=jnp.float32)
    jt = jrouter.MultiIPRouterTrunk(rcfg, dtype=jnp.float32)
    init = lambda jm, seed, *a: realistic(
        jax.eval_shape(jm.init, jax.random.key(seed), *a)["params"], seed=seed)
    pn = init(jn, 251, jnp.asarray(q_flat), jnp.asarray(k_flat))
    pl_ = init(jl, 252, jnp.asarray(q_flat), jnp.asarray(k_flat))
    init_t = lambda key, q, k: jt.init(key, q, k, grid)       # grid stays static
    pt = realistic(jax.eval_shape(init_t, jax.random.key(253), jnp.asarray(q_flat),
                                  jnp.asarray(k_flat))["params"], seed=253)

    def router(params, q, k):
        qn, kn = jn.apply({"params": params[0]}, q, k)
        qp, kp = jl.apply({"params": params[1]}, qn, kn)
        return jt.apply({"params": params[2]}, qp, kp, grid)

    def forward_and_vjp(params, q, k, g):
        out, vjp = jax.vjp(router, params, q, k)
        return out, vjp(g)

    want, ((gpn, gpl, gpt), gq, gk) = jax.jit(forward_and_vjp)(
        (pn, pl_, pt), *map(jnp.asarray, (q_flat, k_flat, cot)))

    mods = [trouter.RouterNorms(qk), trouter.MultiIPRouterLayerProj(qk, qk, **F32),
            trouter.MultiIPRouterTrunk(RouterConfig(**tiny), **F32)]
    for mod, params in zip(mods, (pn, pl_, pt)):
        mod.load_state_dict(jax_params_to_torch(params), strict=True)
    q_t, k_t = (t.requires_grad_() for t in to_torch(q_flat, k_flat))
    got = mods[2](*mods[1](*mods[0](q_t, k_t)), grid)
    got.backward(torch.from_numpy(cot))
    assert got.shape == (b, s, n_id) and max_err(got, want) < 1e-5
    assert _rel(q_t.grad, gq) < 1e-4 and _rel(k_t.grad, gk) < 1e-4
    for mod, grads in zip(mods, (gpn, gpl, gpt)):
        want_g = jax_params_to_torch(jax.tree_util.tree_map(np.asarray, grads))
        assert set(want_g) == {n for n, _ in mod.named_parameters()}
        for name, p in mod.named_parameters():
            w = want_g[name].numpy()
            if name.endswith("to_k.bias"):
                # softmax (and the pair's sigmoid of a difference) ignores a
                # key bias: its true gradient is 0 and both sides hold noise
                assert max(np.abs(w).max(), float(p.grad.abs().max())) < 1e-6, name
            else:
                assert _rel(p.grad, w) < 1e-4, name


# ------------------------------------------------ the model at 97 frames
def _cond(jd, rng, b):
    """Numpy face (ArcFace + CLIP id embedding, 5 ViT scales of 6 tokens)
    and two audio tracks covering the 97 pixel frames, batch b."""
    c, a, lf = jd.cfg, jd.audio_cfg, jd.lfe_cfg
    return dict(id_cond=_normal(rng, b, c.num_ids, lf.id_embed_dim),
                id_vit_hidden=_normal(rng, b, c.num_ids, lf.num_scales, 6, lf.vit_dim),
                audio_embeds=_normal(rng, b, 2, FRAMES + a.window_size - a.window_stride,
                                     a.blocks, a.audio_dim))


@pytest.fixture(scope="module")
def jax_run():
    """The tiny face DiT and VAE (JAX's `DiT.tiny` shapes, weights at
    realistic scale) on both sides, and JAX's results at 97 frames, run
    once: `DiT.apply` on batch-2 CFG shapes and a 2-step `generate` with
    `return_routing`, with the inputs each was given."""
    jd = JDiT.tiny()
    jv = JCausalVAE(JVAEConfig(block_out_channels=(8, 8, 16, 16), layers_per_block=1,
                               latent_channels=4, norm_num_groups=4, dtype=jnp.float32))
    dp = realistic(jax.eval_shape(jd.init, jax.random.key(0)), seed=1)
    vp = realistic(jax.eval_shape(jv.init, jax.random.key(1)), seed=2)
    td, tv = DiT.tiny(device="cpu"), CausalVAE.tiny(device="cpu")
    td.load_state_dict(jax_params_to_torch(dp), strict=True)
    tv.load_state_dict(jax_params_to_torch(vp), strict=True)
    c = jd.cfg
    t_lat = (FRAMES - 1) // c.temporal_compression_ratio + 1
    rng = np.random.default_rng(97)

    # DiT.apply, batch-2 CFG shapes, face + audio
    apply_in = dict(latents=_normal(rng, 2, t_lat, c.in_channels, c.sample_height,
                                    c.sample_width),
                    text=_normal(rng, 2, c.max_text_seq_length, c.text_embed_dim),
                    timesteps=np.array([999.0, 499.0], np.float32), cond=_cond(jd, rng, 2))
    rope = jd.rope(c.sample_height * 8, c.sample_width * 8, t_lat)
    apply = jax.jit(lambda p, x, txt, ts, r, cond: jd.apply(p, x, txt, ts, r,
                                                            num_pixel_frames=FRAMES, **cond))
    out, routing = apply(dp, jnp.asarray(apply_in["latents"]), jnp.asarray(apply_in["text"]),
                         jnp.asarray(apply_in["timesteps"]), rope,
                         {k: jnp.asarray(v) for k, v in apply_in["cond"].items()})

    # a 2-step generate, its initial latents and per-step SDE noise JAX's
    kw = dict(height=c.sample_height * 8, width=c.sample_width * 8, num_frames=FRAMES,
              num_inference_steps=STEPS)
    jp = JPipeline.create(jd, jv, JPipelineConfig(**kw))
    gen_in = dict(prompt=_normal(rng, 1, c.max_text_seq_length, c.text_embed_dim),
                  image=rng.uniform(-1, 1, (1, 1, 3, c.sample_height * 8,
                                            c.sample_width * 8)).astype(np.float32),
                  latents=_normal(rng, 1, t_lat, 4, c.sample_height, c.sample_width),
                  cond=_cond(jd, rng, 1))
    neg = np.zeros_like(gen_in["prompt"])
    key = jax.random.key(7)
    jlat, jr = jp.generate({"dit": dp, "vae": vp}, jnp.asarray(gen_in["prompt"]),
                           jnp.asarray(neg), jnp.asarray(gen_in["image"]), key, decode=False,
                           return_routing=True, latents=jnp.asarray(gen_in["latents"]),
                           **{k: jnp.asarray(v) for k, v in gen_in["cond"].items()})
    # the JAX loop's SDE noise: key -> (carry, init) split, then one split per step
    k, noise = jax.random.split(key)[0], []
    for _ in range(STEPS):
        k, k_noise = jax.random.split(k)
        noise.append(np.array(jax.random.normal(k_noise, gen_in["latents"].shape)))
    return dict(jd=jd, td=td.eval(), tv=tv.eval(), kw=kw, rope=rope, apply_in=apply_in,
                apply_out=(np.asarray(out), np.asarray(routing)), gen_in=gen_in, noise=noise,
                gen_out=(np.asarray(jlat), np.asarray(jr, np.float32)))


def test_face_dit_apply_at_97_frames_matches_jax(jax_run):
    """One fully conditioned forward at T = 25 (the STABs' temporal
    attention over 25 latent frames, the audio windows over 97 + 4 audio
    frames, RoPE over 25 frames) against JAX's `DiT.apply`, and its
    routing [num_ca, B, S, I]."""
    c, x = jax_run["jd"].cfg, jax_run["apply_in"]
    want, want_r = jax_run["apply_out"]
    with torch.no_grad():
        got, got_r = jax_run["td"].apply(
            *to_torch(x["latents"], x["text"], x["timesteps"]),
            tuple(to_torch(*jax_run["rope"])), num_pixel_frames=FRAMES,
            **{k: to_torch(v)[0] for k, v in x["cond"].items()})
    t, h, w = want.shape[1], c.sample_height // c.patch_size, c.sample_width // c.patch_size
    assert t == 25 and got.shape == want.shape
    assert got_r.shape == (c.num_ca, 2, t * h * w, c.num_ids) == want_r.shape
    assert _rel(got, want) < 1e-5 and max_err(got_r, want_r) < 1e-5


def test_generate_at_97_frames_matches_jax_pipeline(jax_run):
    """2 DPM++ steps, face + audio, batch-2 CFG, at 97 frames: the final
    latents and the cond half's routing of every step against JAX's."""
    x, (jlat, jr) = jax_run["gen_in"], jax_run["gen_out"]
    c = jax_run["jd"].cfg
    tp = BindYourAvatarPipeline.create(jax_run["td"], jax_run["tv"],
                                       PipelineConfig(**jax_run["kw"]))
    t = torch.from_numpy
    tlat, tr = tp.generate(t(x["prompt"]), t(np.zeros_like(x["prompt"])), t(x["image"]),
                           torch.Generator().manual_seed(0), decode=False, return_routing=True,
                           latents=t(x["latents"]), noise=[t(n) for n in jax_run["noise"]],
                           **{k: t(v) for k, v in x["cond"].items()})
    assert tlat.shape == jlat.shape and tlat.shape[1] == 25
    assert _rel(tlat, jlat) < 1e-5
    n_tok = 25 * (c.sample_height // c.patch_size) * (c.sample_width // c.patch_size)
    assert tr.dtype == torch.bfloat16
    assert tuple(tr.shape) == jr.shape == (STEPS, c.num_ca, 1, n_tok, c.num_ids)
    assert max_err(tr.float(), jr) <= 2.0 ** -8


def test_cli_at_97_frames_from_two_faces(tmp_path, capsys, monkeypatch):
    """`python -m bindyouravatar_tpu_torch.infer --model_size tiny --device
    cpu --num_frames 97` from two face images and two audio tracks, end
    to end: one generate whose clip has 97 frames, the mp4 and the meta
    line."""
    out = tmp_path / "out"
    argv = ["--model_size", "tiny", "--device", "cpu", "--num_frames", str(FRAMES),
            "--height", "128", "--width", "192", "--num_inference_steps", str(STEPS),
            "--img_file_path"] + [os.path.join(ASSETS, "faces", f"000_{i}.png") for i in (0, 1)]
    argv += ["--audio_path"] + [os.path.join(ASSETS, "audio_emb", f"000_{i}.pt") for i in (0, 1)]
    argv += ["--output_dir", str(out)]
    clips, generate = [], BindYourAvatarPipeline.generate

    def recording(self, *a, **kw):
        video = generate(self, *a, **kw)
        clips.append((tuple(video.shape), kw.get("id_cond") is not None,
                      tuple(kw["audio_embeds"].shape[:3])))
        return video

    monkeypatch.setattr(BindYourAvatarPipeline, "generate", recording)
    path = infer.main(argv)
    meta = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert meta["frames"] == FRAMES and meta["steps"] == STEPS and meta["output"] == path
    assert os.path.isfile(path) and os.path.getsize(path) > 0
    assert clips == [((1, FRAMES, 3, 128, 192), True, (1, 2, FRAMES + 4))]

"""The port's modules against their JAX twins on the same weights, CPU, fp32.

Weights are the flax init's tree redrawn at realistic scale
(`torch_port_utils.realistic`) and moved across with
`convert.jax_params_to_torch`; inputs are made with numpy.  Both sides run
fp32, so the tolerances cover summation order only: 1e-5 relative to the
output's magnitude unless stated.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bindyouravatar_tpu.config import AudioConfig as JAudioConfig, VAEConfig as JVAEConfig
from bindyouravatar_tpu.models import audio as jaudio
from bindyouravatar_tpu.models import layers as jlayers
from bindyouravatar_tpu.models.dit import DiT as JDiT
from bindyouravatar_tpu.models.vae import CausalVAE as JCausalVAE
from bindyouravatar_tpu.ops.rope import get_3d_rotary_pos_embed as jrope
from bindyouravatar_tpu_torch.config import AudioConfig
from bindyouravatar_tpu_torch.convert import jax_params_to_torch
from bindyouravatar_tpu_torch.models import audio as taudio
from bindyouravatar_tpu_torch.models import layers as tlayers
from bindyouravatar_tpu_torch.models.dit import DiT
from bindyouravatar_tpu_torch.models.vae import CausalVAE
from torch_port_utils import max_err, realistic, to_torch

F32 = dict(compute_dtype=torch.float32, dtype=torch.float32)
TINY_AUDIO = dict(dim=96, audio_dim=16, blocks=2, intermediate_dim=16, context_tokens=4,
                  num_attention_heads=6, attention_head_dim=16, num_layers=4)


def _load(module: torch.nn.Module, jax_params) -> torch.nn.Module:
    module.load_state_dict(jax_params_to_torch(jax_params), strict=True)
    return module.eval()


def _rel(got, want) -> float:
    return max_err(got, want) / float(np.abs(np.asarray(want)).max())


def test_convert_roundtrip_tiny_dit():
    """Every leaf of `DiT.tiny(is_train_face=False).init` lands in the
    port's DiT (strict load) with the documented layout changes."""
    jd = JDiT.tiny(is_train_face=False)
    params = realistic(jax.eval_shape(jd.init, jax.random.key(0)))
    model = _load(DiT.tiny(device="cpu", is_train_face=False), params)
    sd = model.state_dict()
    np.testing.assert_array_equal(sd["blocks.3.attn1.to_q.weight"].numpy(),
                                  params["blocks"]["attn1"]["to_q"]["kernel"][3].T)
    np.testing.assert_array_equal(sd["blocks.0.attn1.norm_k.weight"].numpy(),
                                  params["blocks"]["attn1"]["norm_k"]["scale"][0])
    np.testing.assert_array_equal(sd["audio_layers.2.to_out.weight"].numpy(),
                                  params["audio_layers"]["to_out"]["kernel"][2].T)
    np.testing.assert_array_equal(sd["audio_statics.proj.conv.weight"].numpy(),
                                  params["audio_statics"]["proj"]["conv_w"].T)
    n_jax = sum(np.asarray(x).size for x in jax.tree.leaves(params))
    assert n_jax == sum(v.numel() for v in sd.values())


def test_joint_self_attention_fused_flat_path():
    """JAX's fused flat inference path (fuse_qk_norm, S >= 1024, padded to
    2048 and masked) vs the port's flat path: 30 text + 1000 video tokens."""
    heads, d, dim, text_len = 2, 64, 128, 30
    cos, sin = jrope(d, ((0, 0), (10, 25)), (10, 25), 4)          # 1000 video rows
    rng = np.random.default_rng(1)
    hidden = rng.standard_normal((1, 1000, dim)).astype(np.float32)
    enc = rng.standard_normal((1, text_len, dim)).astype(np.float32)
    jm = jlayers.JointSelfAttention(heads=heads, head_dim=d, fuse_qk_norm=True, use_flash=True,
                                    dtype=jnp.float32)
    params = realistic(jax.eval_shape(jm.init, jax.random.key(1), jnp.asarray(hidden),
                                      jnp.asarray(enc), (cos, sin))["params"])
    want_h, want_e = jm.apply({"params": params}, jnp.asarray(hidden), jnp.asarray(enc),
                              (cos, sin))
    tm = _load(tlayers.JointSelfAttention(dim, heads, d, **F32), params)
    with torch.no_grad():
        got_h, got_e = tm(*to_torch(hidden, enc), tuple(to_torch(cos, sin)))
    assert _rel(got_h, want_h) < 1e-5 and _rel(got_e, want_e) < 1e-5


def test_cogvideox_block_matches():
    jd = JDiT.tiny(is_train_face=False)
    c = jd.cfg
    t, hg, wg = c.latent_grid
    cos, sin = jd.rope(c.sample_height * 8, c.sample_width * 8, t)
    rng = np.random.default_rng(2)
    hidden = rng.standard_normal((2, t * hg * wg, c.inner_dim)).astype(np.float32)
    enc = rng.standard_normal((2, c.max_text_seq_length, c.inner_dim)).astype(np.float32)
    temb = rng.standard_normal((2, c.time_embed_dim)).astype(np.float32)
    jm = jlayers.CogVideoXBlock(dim=c.inner_dim, heads=c.num_attention_heads,
                                head_dim=c.attention_head_dim, time_embed_dim=c.time_embed_dim,
                                use_flash=False, dtype=jnp.float32)
    args = (jnp.asarray(hidden), jnp.asarray(enc), jnp.asarray(temb), (cos, sin))
    params = realistic(jax.eval_shape(jm.init, jax.random.key(2), *args)["params"])
    want_h, want_e = jm.apply({"params": params}, *args)
    tm = _load(tlayers.CogVideoXBlock(c.inner_dim, c.num_attention_heads, c.attention_head_dim,
                                      c.time_embed_dim, **F32), params)
    with torch.no_grad():
        got_h, got_e = tm(*to_torch(hidden, enc, temb), tuple(to_torch(cos, sin)))
    assert _rel(got_h, want_h) < 1e-5 and _rel(got_e, want_e) < 1e-5


@pytest.mark.parametrize("uniform", [True, False])
def test_audio_cross_attn_layer_weights_path(uniform):
    """Frame-local audio cross-attention with the routing weights fused in
    (0.5 everywhere, as audio-only serving gives, and non-uniform)."""
    cfg = JAudioConfig(**TINY_AUDIO)
    b, f, hw, n_id = 2, 3, 96, 2
    rng = np.random.default_rng(3)
    video = rng.standard_normal((b, f * hw, cfg.dim)).astype(np.float32)
    ctx = rng.standard_normal((b, n_id, f, cfg.context_tokens, cfg.audio_dim)).astype(np.float32)
    w = (np.full((b, f * hw, n_id), 0.5, np.float32) if uniform
         else rng.uniform(0, 1, (b, f * hw, n_id)).astype(np.float32))
    jm = jaudio.AudioCrossAttnLayer(cfg, dtype=jnp.float32)
    params = realistic(jax.eval_shape(jm.init, jax.random.key(3), jnp.asarray(video),
                                      jnp.asarray(ctx))["params"])
    want = jm.apply({"params": params}, jnp.asarray(video), jnp.asarray(ctx),
                    weights=jnp.asarray(w))
    tm = _load(taudio.AudioCrossAttnLayer(AudioConfig(**TINY_AUDIO), **F32), params)
    with torch.no_grad():
        got = tm(*to_torch(video, ctx, w))
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("tracks", [1, 2])
def test_audio_statics_matches(tracks):
    """Window MLP + odd-first downsample (49 -> 25 -> 13 frames at full
    size; 9 -> 5 -> 3 here) + fused LN; one track adds the mute fixture."""
    cfg = JAudioConfig(**TINY_AUDIO)
    frames = 9
    n_af = frames + cfg.window_size - cfg.window_stride
    rng = np.random.default_rng(4)
    audio = rng.standard_normal((2, tracks, n_af, cfg.blocks, cfg.audio_dim)).astype(np.float32)
    mute = rng.standard_normal((n_af, cfg.blocks, cfg.audio_dim)).astype(np.float32)
    jm = jaudio.AudioStatics(cfg, dtype=jnp.float32)
    init = lambda key, a, m: jm.init(key, a, frames, m)       # frames stays static
    params = realistic(jax.eval_shape(init, jax.random.key(4), jnp.asarray(audio),
                                      jnp.asarray(mute))["params"])
    want = jm.apply({"params": params}, jnp.asarray(audio), frames, jnp.asarray(mute))
    tm = _load(taudio.AudioStatics(AudioConfig(**TINY_AUDIO), **F32), params)
    with torch.no_grad():
        got = tm(*to_torch(audio), frames, *to_torch(mute))
    assert got.shape == (2, 2, 3, cfg.context_tokens, cfg.audio_dim) == want.shape
    assert _rel(got, want) < 1e-5


def test_causal_vae_encode_decode():
    """Tiny VAE (the serving tests' config): encode, one-pass decode and
    the chunked decode, against the JAX VAE."""
    jv = JCausalVAE(JVAEConfig(block_out_channels=(8, 8, 16, 16), layers_per_block=1,
                               latent_channels=4, norm_num_groups=4, dtype=jnp.float32))
    params = realistic(jax.eval_shape(jv.init, jax.random.key(5)))
    tv = _load(CausalVAE.tiny(device="cpu"), params)
    rng = np.random.default_rng(5)
    video = rng.uniform(-1, 1, (1, 9, 3, 32, 48)).astype(np.float32)
    latents = rng.standard_normal((1, 5, 4, 4, 6)).astype(np.float32)
    with torch.no_grad():
        enc = tv.encode(*to_torch(video))
        dec = tv.decode(*to_torch(latents))
        dec_chunked = tv.decode(*to_torch(latents), temporal_chunk=2)
    assert enc.shape == (1, 3, 4, 4, 6) and dec.shape == (1, 17, 3, 32, 48)
    assert _rel(enc, jv.encode(params, jnp.asarray(video))) < 1e-5
    assert _rel(dec, jv.decode(params, jnp.asarray(latents))) < 1e-5
    assert _rel(dec_chunked, jv.decode(params, jnp.asarray(latents), temporal_chunk=2)) < 1e-5


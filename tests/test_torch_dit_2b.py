"""The 2B variant of the DiT (`use_rotary_positional_embeddings=False`:
the CogVideoX-2B sincos table, no RoPE, `norm_final` on the video rows)
against the JAX package on the CPU, fp32.

The table exactly; a tiny 2B DiT with face + audio on (2 layers, one face
injection, LoRA r4; JAX's own test runs it bare) on converted weights:
output and routing within 1e-5 relative to the output's magnitude, and
the gradients of a fixed linear function of both against JAX's
(`jax.grad`): all of them together within relative L2 1e-5, each tensor
within 1e-4 (the timestep MLP's gradient sums every layer's, 1.2e-5 apart
in fp32); an attention's key bias and its key norm's bias, whose true
gradients are 0 (softmax is invariant to them), are held against their
query twins' norms.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bindyouravatar_tpu.models.dit import DiT as JDiT
from bindyouravatar_tpu.ops import rope as jrope
from bindyouravatar_tpu_torch.convert import jax_params_to_torch
from bindyouravatar_tpu_torch.models.dit import DiT
from bindyouravatar_tpu_torch.ops import rope
from bindyouravatar_tpu_torch.training.checkpoint import base_names
from torch_port_utils import max_err, realistic, threads_per_worker, to_torch

TWO_B = dict(use_rotary_positional_embeddings=False, num_layers=2, lora_rank=4)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    with threads_per_worker():
        yield


def _jax_table(c) -> np.ndarray:
    """JAX `DiT.init`'s `pos_embedding` (`dit.py:186-192`), built as it
    builds it: zero text rows, the sincos table of the latent grid."""
    t, hg, wg = c.latent_grid
    pos = jrope.get_3d_sincos_pos_embed(c.inner_dim, (hg, wg), t, c.spatial_interpolation_scale,
                                        c.temporal_interpolation_scale).reshape(1, -1, c.inner_dim)
    joint = np.zeros((1, c.max_text_seq_length + pos.shape[1], c.inner_dim), np.float32)
    joint[:, c.max_text_seq_length:] = pos
    return joint


@pytest.fixture(scope="module")
def models():
    jd = JDiT.tiny(**TWO_B)
    real = realistic(jax.eval_shape(jd.init, jax.random.key(0)), seed=4)
    assert real["pos_embedding"].shape == _jax_table(jd.cfg).shape
    real["pos_embedding"] = _jax_table(jd.cfg)               # the fixed table, as JAX inits it
    td = DiT.tiny(device="cpu", **TWO_B)
    td.load_state_dict(jax_params_to_torch(real), strict=True)
    return jd, real, td


def _inputs(jd, seed=3, b=2):
    c, a, lf = jd.cfg, jd.audio_cfg, jd.lfe_cfg
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    n_af = c.sample_frames + a.window_size - a.window_stride
    return dict(lat=f(b, c.latent_frames, c.in_channels, c.sample_height, c.sample_width),
                txt=f(b, c.max_text_seq_length, c.text_embed_dim),
                ts=np.array([999.0, 321.0][:b], np.float32),
                cond=dict(id_cond=f(b, c.num_ids, lf.id_embed_dim),
                          id_vit_hidden=f(b, c.num_ids, lf.num_scales, 6, lf.vit_dim),
                          audio_embeds=f(b, 2, n_af, a.blocks, a.audio_dim)))


@pytest.mark.parametrize("grid,frames,scales", [((8, 12), 3, (1.875, 1.0)),
                                                ((30, 45), 13, (1.875, 1.0)),
                                                ((5, 7), 2, (1.0, 2.0))])
def test_sincos_table_equals_jax(grid, frames, scales):
    """`get_3d_sincos_pos_embed` and `get_1d_sincos_pos_embed_np` against
    JAX's, float64, exactly (the 5B-size grid 30 x 45 x 13 among them)."""
    for dim in (96, 1920):
        got = rope.get_3d_sincos_pos_embed(dim, grid, frames, *scales)
        want = jrope.get_3d_sincos_pos_embed(dim, grid, frames, *scales)
        assert got.dtype == np.float64 and np.array_equal(got, want)
    pos = np.arange(7, dtype=np.float64) / 1.875
    assert np.array_equal(rope.get_1d_sincos_pos_embed_np(48, pos),
                          jrope.get_1d_sincos_pos_embed_np(48, pos))


def test_pos_embedding_init_and_conversion(models):
    """The drawn DiT's `pos_embedding` is JAX's init (`_jax_table`) bit for bit ([1, 226 +
    S, dim], zero text rows); the converter carries JAX's across; the
    reference readers leave it out of the base transformer (diffusers keeps
    the table out of the state dict); `rope` gives no tables."""
    jd, real, _ = models
    c = jd.cfg
    drawn = DiT.tiny(device="cpu", generator=torch.Generator().manual_seed(0), **TWO_B)
    want = torch.from_numpy(_jax_table(c))
    assert drawn.pos_embedding.shape == (1, c.max_text_seq_length + c.video_seq_len, c.inner_dim)
    assert torch.equal(drawn.pos_embedding, want)
    assert float(drawn.pos_embedding[0, :c.max_text_seq_length].abs().max()) == 0.0
    assert torch.equal(jax_params_to_torch(real)["pos_embedding"], want)
    assert "pos_embedding" not in base_names(drawn)
    assert drawn.rope(128, 192, 3) is None


@pytest.fixture(scope="module")
def jax_outputs(models):
    """JAX's forward and its gradients of sum(out * w) + sum(routing * w_r)."""
    jd, real, _ = models
    x = _inputs(jd)
    c = jd.cfg
    rng = np.random.default_rng(8)
    w = rng.standard_normal((2, c.latent_frames, c.out_channels, c.sample_height,
                             c.sample_width)).astype(np.float32)
    w_r = rng.standard_normal((c.num_ca, 2, c.video_seq_len, c.num_ids)).astype(np.float32)
    cond = {k: jnp.asarray(v) for k, v in x["cond"].items()}

    def loss(p):
        out, routing = jd.apply(p, jnp.asarray(x["lat"]), jnp.asarray(x["txt"]),
                                jnp.asarray(x["ts"]), None, **cond)
        return jnp.sum(out * w) + jnp.sum(routing * w_r), (out, routing)

    (_, (out, routing)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.tree.map(jnp.asarray, real))
    return x, w, w_r, np.asarray(out), np.asarray(routing), jax.tree.map(np.asarray, grads)


def test_two_b_forward_matches_jax(models, jax_outputs):
    """Face + audio on: output and routing against JAX's `apply` (rope=None)."""
    jd, _, td = models
    x, _, _, out, routing, _ = jax_outputs
    with torch.no_grad():
        got, got_r = td.apply(*to_torch(x["lat"], x["txt"], x["ts"]), None,
                              **{k: to_torch(v)[0] for k, v in x["cond"].items()})
    assert max_err(got, out) / float(np.abs(out).max()) < 1e-5
    assert got_r.shape == routing.shape == (jd.cfg.num_ca, 2, jd.cfg.video_seq_len, 2)
    assert max_err(got_r, routing) < 1e-5
    with pytest.raises(ValueError, match="RoPE"):
        td.apply(*to_torch(x["lat"], x["txt"], x["ts"]),
                 tuple(to_torch(*jd.rope(128, 192, 3))))


def test_two_b_training_gradients_match_jax(models, jax_outputs):
    """Every parameter's gradient on the training path (B10's and B11 / B12 +
    B13's plain versions on the CPU) against `jax.grad`."""
    jd, _, td = models
    x, w, w_r, _, _, grads = jax_outputs
    td.zero_grad()
    out, routing = td.apply(*to_torch(x["lat"], x["txt"], x["ts"]), None,
                            **{k: to_torch(v)[0] for k, v in x["cond"].items()})
    ((out * torch.from_numpy(w)).sum() + (routing * torch.from_numpy(w_r)).sum()).backward()
    want = jax_params_to_torch(grads)
    # no gradient reaches the mute tokens with two audio tracks: zero in JAX
    got = {k: torch.zeros_like(p) if p.grad is None else p.grad for k, p in td.named_parameters()}
    assert set(want) == set(got)
    assert float(want["pos_embedding"].abs().max()) > 0.0
    key_bias = ("to_k.bias", "norm_k.bias")
    for k, g in got.items():
        # softmax is invariant to a key bias: its true gradient is 0
        ref = want[k.replace("_k.bias", "_q.bias")] if k.endswith(key_bias) else want[k]
        rel = float((g - want[k]).norm()) / max(float(ref.norm()), 1e-30)
        assert rel <= 1e-4, (k, rel)
    rest = [k for k in got if not k.endswith(key_bias)]
    diff = sum(float((got[k] - want[k]).double().square().sum()) for k in rest)
    norm = sum(float(want[k].double().square().sum()) for k in rest)
    assert (diff / norm) ** 0.5 <= 1e-5

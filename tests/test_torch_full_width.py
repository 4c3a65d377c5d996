"""The port's `DiT.apply` against the JAX package's at the 5B widths, on the CPU.

`DiTConfig` defaults (dim 3072, 48 x 64 heads, 48 input channels, text
dim 4096, 32 face tokens) with the sub-configs `DiT.create` gives them on
both sides: `AudioConfig()`, `LFEConfig()` and `RouterConfig()` at the
DiT's width and depth (the router's `num_layers` is the DiT's face-layer
count).  Depth is cut to 2 layers: layer 0 is a face layer under the
`cross_attn_interval = 2` rule, layer 1 is not, and both take audio.  Batch
1 on a 2 x 30 x 45 latent grid: 2,700 video rows (past the 1,024 rows
where JAX's fused flat attention starts) at the 5B (h, w), so the router's
h-major q/k packing at 48 heads and the grid reshapes run at their 5B
shapes, beside 226 text rows.  Inference path (`fuse_qk_norm=True`, as the
pipeline sets it), face + audio on, fp32 on both sides: JAX through its XLA
path, the port through its plain versions.

Weights: one numpy draw handed to both (`convert.jax_params_to_torch`):
every matrix or conv kernel ~ N(0, 1 / fan_in), norm gains ~ N(1, 0.1),
every other leaf (biases, norm shifts, tokens) ~ N(0, 0.1).  At N(0, 0.1)
kernels (`torch_port_utils.realistic`) activations grow about 5x a layer
at width 3072; here they stay O(1)-O(100).

Tolerance: relative L2 <= 1e-4 for the noise prediction and for each
router layer's routing logits (fp32 sums of 3,072-wide rows in another
order on the two sides).
"""

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bindyouravatar_tpu.config import DiTConfig as JDiTConfig
from bindyouravatar_tpu.models.dit import DiT as JDiT
from bindyouravatar_tpu_torch.config import DiTConfig
from bindyouravatar_tpu_torch.convert import jax_params_to_torch
from bindyouravatar_tpu_torch.models.dit import DiT
from torch_port_utils import threads_per_worker

LAYERS, FRAMES = 2, 5            # 5 pixel frames -> 2 latent frames
REL_L2 = 1e-4


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _draw(shapes, seed: int):
    """Numpy weights of `shapes` (a tree of ShapeDtypeStructs), see the
    module docstring; each leaf is put on JAX's CPU device as it is drawn,
    so the draw and JAX's copy never both hold the whole tree."""
    rng = np.random.default_rng(seed)

    def draw(path, x):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "scale":
            a = 1.0 + 0.1 * rng.standard_normal(x.shape, dtype=np.float32)
        elif len(x.shape) >= 2:
            fan_in = int(np.prod(x.shape[:-1]))
            a = rng.standard_normal(x.shape, dtype=np.float32)
            a *= np.float32(fan_in ** -0.5)
        else:
            a = 0.1 * rng.standard_normal(x.shape, dtype=np.float32)
        return jnp.asarray(a)

    return jax.tree_util.tree_map_with_path(draw, shapes)



@pytest.fixture(autouse=True, scope="module")
def _threads():
    with threads_per_worker():
        yield

@pytest.fixture(scope="module")
def run():
    """Both forwards on the same weights and inputs: (JAX output, JAX
    routing, port output, port routing, config)."""
    kw = dict(num_layers=LAYERS, sample_frames=FRAMES, fuse_qk_norm=True)
    jd = JDiT.create(JDiTConfig(dtype=jnp.float32, param_dtype=jnp.float32, **kw))
    c, a, lf = jd.cfg, jd.audio_cfg, jd.lfe_cfg
    t, h, w = c.latent_grid
    rng = np.random.default_rng(1)
    f32 = lambda *shape: rng.standard_normal(shape, dtype=np.float32)
    inputs = dict(
        latents=f32(1, t, c.in_channels, h * c.patch_size, w * c.patch_size),
        text_embeds=f32(1, c.max_text_seq_length, c.text_embed_dim),
        timesteps=np.array([501.0], np.float32))
    cond = dict(id_cond=f32(1, c.num_ids, lf.id_embed_dim),
                id_vit_hidden=f32(1, c.num_ids, lf.num_scales, 577, lf.vit_dim),
                audio_embeds=f32(1, 2, FRAMES + a.window_size - a.window_stride, a.blocks,
                                 a.audio_dim),
                af_matrix=np.array([[[0.0, 1.0], [1.0, 0.0]]], np.float32))
    rope = jd.rope(h * c.patch_size * 8, w * c.patch_size * 8, t)

    # JAX as its pipeline runs it: the once-per-clip conditioning (the
    # 1.2 B-parameter audio projection) in one call, then `apply` on it
    params = _draw(jax.eval_shape(jd.init, jax.random.key(0)), seed=0)
    jcond = {k: jnp.asarray(v) for k, v in cond.items()}
    face_emb, audio_ctx = jax.jit(functools.partial(jd.prepare_conditioning,
                                                    num_pixel_frames=FRAMES))(
        params, id_cond=jcond["id_cond"], id_vit_hidden=jcond["id_vit_hidden"],
        audio_embeds=jcond["audio_embeds"])

    # the port's copy of every subtree.  JAX's apply below runs on the
    # precomputed conditioning, so its audio projection (4.8 of the draw's
    # 7.1 GB in fp32) goes to the port alone, its kernel as a view:
    # `conv_w` [2C, C] -> `conv.weight` [C, 2C], the converter's rule
    proj = params.pop("audio_statics")
    with warnings.catch_warnings():    # JAX's buffer is read-only; the port only reads it
        warnings.simplefilter("ignore", UserWarning)
        conv_w = torch.from_numpy(np.asarray(proj["proj"].pop("conv_w")))
    state = jax_params_to_torch({"audio_statics": jax.tree.map(np.asarray, proj)})
    state["audio_statics.proj.conv.weight"] = conv_w.T
    del proj, conv_w
    for top in params:
        state.update(jax_params_to_torch({top: jax.tree.map(np.asarray, params[top])}))
    td = DiT.create(DiTConfig(dtype=torch.float32, param_dtype=torch.float32, **kw),
                    device="cpu")
    td.load_state_dict(state, strict=True, assign=True)
    del state
    tt = lambda x: torch.from_numpy(np.array(x, np.float32))
    with torch.inference_mode():
        got, got_r = td.apply(*(tt(v) for v in inputs.values()), (tt(rope[0]), tt(rope[1])),
                              **{k: tt(v) for k, v in cond.items()})
    got, got_r = got.numpy(), got_r.numpy()
    del td

    want, want_r = jax.jit(jd.apply)(params, *(jnp.asarray(v) for v in inputs.values()), rope,
                                     face_emb=face_emb, audio_ctx=audio_ctx,
                                     af_matrix=jcond["af_matrix"])
    return np.asarray(want), np.asarray(want_r), got, got_r, DiTConfig(**kw)


def test_full_width_noise_prediction_matches_jax(run):
    want, _, got, _, c = run
    t, h, w = c.latent_grid
    assert c.inner_dim == 3072 and c.num_attention_heads == 48 and c.in_channels == 48
    assert t * h * w > 1024 and (h, w) == (30, 45)
    assert got.shape == want.shape == (1, t, c.out_channels, h * 2, w * 2)
    assert np.isfinite(got).all()
    assert 1.0 < float(np.abs(want).max()) < 1e3       # the draw keeps O(1)-O(100)
    assert _rel_l2(got, want) <= REL_L2


def test_full_width_routing_logits_match_jax(run):
    """One router layer (layer 0 of 2 is the face layer): its routing
    logits [num_ca, B, S, I], compared layer by layer."""
    _, want_r, _, got_r, c = run
    assert c.num_ca == 1
    assert got_r.shape == want_r.shape == (1, 1, c.latent_grid[0] * 30 * 45, c.num_ids)
    for layer in range(c.num_ca):
        assert _rel_l2(got_r[layer], want_r[layer]) <= REL_L2
    # the routing is not saturated: both identities and the background occur
    assert 0.05 < float((want_r > 0.5).mean()) < 0.95

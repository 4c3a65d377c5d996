"""The face path's modules against their JAX twins on the same weights, CPU, fp32.

Weights are the flax init's tree redrawn at realistic scale
(`torch_port_utils.realistic`) and moved across with
`convert.jax_params_to_torch`; inputs are made with numpy.  Both sides run
fp32, so the tolerances cover summation order only: 1e-5 relative to the
output's magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bindyouravatar_tpu.config import LFEConfig as JLFEConfig, RouterConfig as JRouterConfig
from bindyouravatar_tpu.models import lfe as jlfe
from bindyouravatar_tpu.models import router as jrouter
from bindyouravatar_tpu.models.dit import DiT as JDiT
from bindyouravatar_tpu_torch.config import LFEConfig, RouterConfig
from bindyouravatar_tpu_torch.convert import jax_params_to_torch
from bindyouravatar_tpu_torch.models import lfe as tlfe
from bindyouravatar_tpu_torch.models import router as trouter
from bindyouravatar_tpu_torch.models.dit import DiT
from torch_port_utils import max_err, realistic, to_torch

F32 = dict(compute_dtype=torch.float32, dtype=torch.float32)
TINY_ROUTER = dict(num_id_token=8, num_heads=4, num_layers=2, q_k_dim=64, num_attention_layers=2,
                   attn_heads=4)
TINY_LFE = dict(dim=32, depth=5, dim_head=8, heads=4, num_id_token=2, num_queries=8,
                output_dim=64, id_embed_dim=24, vit_dim=16)


def _load(module: torch.nn.Module, jax_params) -> torch.nn.Module:
    module.load_state_dict(jax_params_to_torch(jax_params), strict=True)
    return module.eval()


def _rel(got, want) -> float:
    return max_err(got, want) / float(np.abs(np.asarray(want)).max())


def _init(jm, seed, *args):
    return realistic(jax.eval_shape(jm.init, jax.random.key(seed), *args)["params"], seed=seed)


def test_convert_roundtrip_face_dit():
    """Every leaf of the face-on `DiT.tiny().init` lands in the port's DiT
    (strict load): stack-split perceiver and router layers, the trunk's
    [d, 1] `final_proj` kernel as a [1, d] weight, the LFE's raw params in
    the JAX orientation."""
    params = realistic(jax.eval_shape(JDiT.tiny().init, jax.random.key(0)))
    model = DiT.tiny(device="cpu")
    model.load_state_dict(jax_params_to_torch(params), strict=True)
    sd = model.state_dict()
    np.testing.assert_array_equal(sd["perceivers.1.to_q.weight"].numpy(),
                                  params["perceiver"]["to_q"]["kernel"][1].T)
    np.testing.assert_array_equal(sd["perceivers.0.norm1.weight"].numpy(),
                                  params["perceiver"]["norm1"]["scale"][0])
    np.testing.assert_array_equal(sd["router_layers.1.to_k.weight"].numpy(),
                                  params["router_layers"]["to_k"]["kernel"][1].T)
    np.testing.assert_array_equal(sd["router_trunk.final_proj.weight"].numpy(),
                                  params["router_trunk"]["final_proj"]["kernel"].T)
    np.testing.assert_array_equal(sd["router_trunk.st_1.multi_id_attn.to_v.bias"].numpy(),
                                  params["router_trunk"]["st_1"]["multi_id_attn"]["to_v"]["bias"])
    np.testing.assert_array_equal(sd["lfe.proj_out"].numpy(), params["lfe"]["proj_out"])
    np.testing.assert_array_equal(sd["lfe.latents"].numpy(), params["lfe"]["latents"])
    np.testing.assert_array_equal(sd["lfe.attn_4.to_kv.weight"].numpy(),
                                  params["lfe"]["attn_4"]["to_kv"]["kernel"].T)
    n_jax = sum(np.asarray(x).size for x in jax.tree.leaves(params))
    assert n_jax == sum(v.numel() for v in sd.values())


@pytest.mark.parametrize("return_pre_out", [False, True])
def test_perceiver_cross_attention(return_pre_out):
    """Face injection through B2's plain version, both output forms, and the
    detached q/k hand-off in the h-major flat packing."""
    b, n_id, n_tok, s, dim, heads, dh, kv_dim = 2, 2, 8, 40, 96, 4, 16, 64
    rng = np.random.default_rng(31)
    face = rng.standard_normal((b, n_id, n_tok, kv_dim)).astype(np.float32)
    video = rng.standard_normal((b, s, dim)).astype(np.float32)
    kw = dict(dim=dim, dim_head=dh, heads=heads, kv_dim=kv_dim, dtype=jnp.float32)
    # the full tree (with to_out), applied by either form, as `DiT.apply` does
    params = _init(jrouter.PerceiverCrossAttention(**kw), 31, jnp.asarray(face),
                   jnp.asarray(video))
    jm = jrouter.PerceiverCrossAttention(return_pre_out=return_pre_out, **kw)
    want_o, want_q, want_k = jm.apply({"params": params}, jnp.asarray(face), jnp.asarray(video))
    tm = _load(trouter.PerceiverCrossAttention(dim, dh, heads, kv_dim, return_pre_out, **F32),
               params)
    with torch.no_grad():
        got_o, got_q, got_k = tm(*to_torch(face, video))
    want_o = np.asarray(want_o)
    if return_pre_out:                     # JAX [B, I, H, S, dh] -> [B, I, S, H*dh]
        want_o = want_o.transpose(0, 1, 3, 2, 4).reshape(b, n_id, s, heads * dh)
    assert _rel(got_o, want_o) < 1e-5
    assert _rel(got_q, want_q) < 1e-5 and _rel(got_k, want_k) < 1e-5


@pytest.mark.parametrize("s,heads", [(96, 4), (1056, 2), (1056, 1)])
def test_self_attention(s, heads):
    """The STAB spatial attention: plain SDPA at short lengths, B1's bare
    path (no QK-LN, no RoPE) at S >= 1024 with 64-wide heads and with
    128-wide heads (JAX's flash kernel at `dh % 64 == 0`)."""
    dim = 128
    rng = np.random.default_rng(32)
    x = rng.standard_normal((2, s, dim)).astype(np.float32)
    jm = jrouter.SelfAttention(dim, heads, dtype=jnp.float32)
    params = _init(jm, 32, jnp.asarray(x))
    want = jm.apply({"params": params}, jnp.asarray(x))
    tm = _load(trouter.SelfAttention(dim, heads, **F32), params)
    with torch.no_grad():
        got = tm(*to_torch(x))
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("axis,t", [(1, 3), (2, 13), (2, 3)])
def test_axis_attention(axis, t):
    """Multi-ID (axis 1, I = 2, through B4) and temporal (axis 2, through
    B5 at 13 frames and B5' at 3) attention on [B, I, T, H, W, C]."""
    dim, heads = 32, 4
    rng = np.random.default_rng(33)
    x = rng.standard_normal((2, 2, t, 3, 4, dim)).astype(np.float32)
    jm = jrouter.AxisAttention(dim, axis=axis, heads=heads, dtype=jnp.float32)
    params = _init(jm, 33, jnp.asarray(x))
    want = jm.apply({"params": params}, jnp.asarray(x))
    tm = _load(trouter.AxisAttention(dim, axis, heads, **F32), params)
    with torch.no_grad():
        got = tm(*to_torch(x))
    assert got.shape == x.shape and _rel(got, want) < 1e-5


def test_spatial_temporal_attention_block():
    dim, heads = 32, 4
    rng = np.random.default_rng(34)
    x = rng.standard_normal((2, 2, 3, 4, 5, dim)).astype(np.float32)
    jm = jrouter.SpatialTemporalAttentionBlock(dim=dim, heads=heads, dtype=jnp.float32)
    params = _init(jm, 34, jnp.asarray(x))
    want = jm.apply({"params": params}, jnp.asarray(x))
    tm = _load(trouter.SpatialTemporalAttentionBlock(dim, heads, **F32), params)
    with torch.no_grad():
        got = tm(*to_torch(x))
    assert _rel(got, want) < 1e-5


def test_router_pos_emb_copy_matches():
    """The port's copy of the numpy pos-emb table, on the canonical grid."""
    for grid, feat in (((13, 30, 45), 512), ((3, 4, 6), 32)):
        np.testing.assert_array_equal(trouter._router_pos_emb(*grid, feat),
                                      jrouter._router_pos_emb(*grid, feat))


def test_router_norms_layer_proj_and_trunk():
    """Shared norms -> one layer's projections -> the trunk (re-attention
    features token-major/head-minor, pos-emb, 2 STABs, MulReduceDense,
    sigmoid) on a (3, 4, 6) grid: routing [B, S, I]."""
    rcfg = JRouterConfig(**TINY_ROUTER)
    grid, b, n_id = (3, 4, 6), 2, 2
    s, qk = 3 * 4 * 6, rcfg.q_k_dim
    rng = np.random.default_rng(35)
    q_flat = rng.standard_normal((b, s, qk)).astype(np.float32)
    k_flat = rng.standard_normal((b, n_id, rcfg.num_id_token, qk)).astype(np.float32)
    jn = jrouter.RouterNorms(q_k_dim=qk)
    jl = jrouter.MultiIPRouterLayerProj(q_k_dim=qk, dtype=jnp.float32)
    jt = jrouter.MultiIPRouterTrunk(rcfg, dtype=jnp.float32)
    pn = _init(jn, 35, jnp.asarray(q_flat), jnp.asarray(k_flat))
    pl_ = _init(jl, 36, jnp.asarray(q_flat), jnp.asarray(k_flat))
    init_t = lambda key, q, k: jt.init(key, q, k, grid)       # grid stays static
    pt = realistic(jax.eval_shape(init_t, jax.random.key(37), jnp.asarray(q_flat),
                                  jnp.asarray(k_flat))["params"], seed=37)
    jqn, jkn = jn.apply({"params": pn}, jnp.asarray(q_flat), jnp.asarray(k_flat))
    jqp, jkp = jl.apply({"params": pl_}, jqn, jkn)
    want = jt.apply({"params": pt}, jqp, jkp, grid)
    tn = _load(trouter.RouterNorms(qk), pn)
    tl = _load(trouter.MultiIPRouterLayerProj(qk, qk, **F32), pl_)
    tt = _load(trouter.MultiIPRouterTrunk(RouterConfig(**TINY_ROUTER), **F32), pt)
    with torch.no_grad():
        qn, kn = tn(*to_torch(q_flat, k_flat))
        qp, kp = tl(qn, kn)
        got = tt(qp, kp, grid)
    assert _rel(qn, jqn) < 1e-5 and _rel(kn, jkn) < 1e-5
    assert _rel(qp, jqp) < 1e-5 and _rel(kp, jkp) < 1e-5
    assert got.shape == (b, s, n_id) and max_err(got, want) < 1e-5


def test_local_facial_extractor():
    """LFE: id mapping, 5 scales x 1 perceiver layer each, 8 face tokens."""
    rng = np.random.default_rng(38)
    idc = rng.standard_normal((4, 24)).astype(np.float32)
    vit = rng.standard_normal((4, 5, 6, 16)).astype(np.float32)
    jm = jlfe.LocalFacialExtractor(JLFEConfig(**TINY_LFE), dtype=jnp.float32)
    params = _init(jm, 38, jnp.asarray(idc), jnp.asarray(vit))
    want = jm.apply({"params": params}, jnp.asarray(idc), jnp.asarray(vit))
    tm = _load(tlfe.LocalFacialExtractor(LFEConfig(**TINY_LFE), **F32), params)
    with torch.no_grad():
        got = tm(*to_torch(idc, vit))
    assert got.shape == (4, 8, 64) and _rel(got, want) < 1e-5

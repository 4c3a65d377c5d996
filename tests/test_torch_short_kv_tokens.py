"""The short-KV kernels' functions at other token and identity counts,
against the JAX package on the CPU, in fp32.

The card's short-KV kernels (B2, B2h, B2c, B14 in both modes, B3) take any
K tokens an identity and any I identities: K = 32 with I <= 4 on the
shipped 32-key block, every other K and I on the general 64-key block
(`csrc/short_kv_attention.cu`).  Here, where a CPU tensor takes each
kernel's plain version:
  * each plain version against the TPU body it replaces (`_kernel`,
    `_kernel_qmajor`, `_kernel_flat`) run by `pl.pallas_call` in interpret
    mode, as the JAX package's tests run it, at K = 4, 8, 24, 64 and I = 1,
    3, 5, with 2 heads of 128 (a head fills 128 lanes, as
    `_call_kernel_flat` asserts), over two batches of 16 rows; fp32 on both
    sides, so the differences are summation order: the existing short-KV
    tolerances (1e-5 of the output's magnitude; B3 2e-5 absolute).  Each
    body runs once per (K, I), shared by the kernels' cases: the 60
    interpret-mode calls are most of the file's time;
  * the wrappers' shape rule at such K and I on meta tensors (no kernel
    takes them): each passes the rule and refuses only the device;
  * `DiT.create`'s face + audio DiT at the tiny tier's widths with 3 and 5
    identities and 24 / 16 and 56 / 64 face / audio tokens an identity, on
    weights converted from JAX's, against JAX's `DiT.apply`: the output
    within 1e-5 of its magnitude and the routing within 1e-5 absolute, as
    the tiny tier's DiT cases.  (Both packages' router adds a 3-D sincos
    table over K_f x its heads channels, whose third must be even: at 4
    router heads 16 and 64 face tokens raise in JAX and in the port alike,
    so the face tokens here are 24 and 56.)
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from bindyouravatar_tpu import config as jconfig
from bindyouravatar_tpu.models.dit import DiT as JDiT
from bindyouravatar_tpu.ops import short_kv_attention as jskv
from bindyouravatar_tpu_torch import config as tconfig
from bindyouravatar_tpu_torch.convert import jax_params_to_torch
from bindyouravatar_tpu_torch.models.dit import DiT
from bindyouravatar_tpu_torch.ops import short_kv_attention as tskv
from torch_port_utils import max_err, realistic, threads_per_worker, to_torch

KS = (4, 8, 24, 64)
IDS = (1, 3, 5)
G, H, SQ, D, ROWS, SCALE = 2, 2, 16, 128, 16, 0.19
HPB = max(1, 128 // D)          # `_call_kernel_flat`'s heads a block (one of 128 lanes)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    with threads_per_worker():
        yield


def _rel(got, want) -> float:
    return max_err(got, want) / float(np.abs(np.asarray(want)).max())


@functools.lru_cache(maxsize=None)
def _jax_bodies(kk: int, n_id: int):
    """The inputs (q head-major [G, H, Sq, D], k, v [G, I, H, K, D], w
    [G, Sq, I]) at K = kk, I = n_id and the TPU bodies' outputs on them, in
    interpret mode, 16-row query blocks: `_kernel` per identity and
    combined, `_kernel_qmajor` both (on q-major q), `_kernel_flat` (on the
    flat q).  Computed once per (K, I) for every kernel's case."""
    rng = np.random.default_rng(100 * kk + n_id)
    q = rng.standard_normal((G, H, SQ, D)).astype(np.float32)
    k, v = (rng.standard_normal((G, n_id, H, kk, D)).astype(np.float32) for _ in range(2))
    w = rng.uniform(size=(G, SQ, n_id)).astype(np.float32)
    q_q = np.ascontiguousarray(q.transpose(0, 2, 1, 3))            # [G, Sq, H, D]
    q_f = q_q.reshape(G, SQ, H * D)
    kvspec = pl.BlockSpec((1, n_id, H, kk, D), lambda gi, qi: (gi, 0, 0, 0, 0))
    wspec = pl.BlockSpec((1, ROWS, n_id), lambda gi, qi: (gi, qi, 0))
    out = {}
    for body, qmajor in ((jskv._kernel, False), (jskv._kernel_qmajor, True)):
        if qmajor:
            qspec = pl.BlockSpec((1, ROWS, H, D), lambda gi, qi: (gi, qi, 0, 0))
            ospec_i = pl.BlockSpec((1, n_id, ROWS, H, D), lambda gi, qi: (gi, 0, qi, 0, 0))
            shape_c, shape_i = (G, SQ, H, D), (G, n_id, SQ, H, D)
        else:
            qspec = pl.BlockSpec((1, H, ROWS, D), lambda gi, qi: (gi, 0, qi, 0))
            ospec_i = pl.BlockSpec((1, n_id, H, ROWS, D), lambda gi, qi: (gi, 0, 0, qi, 0))
            shape_c, shape_i = (G, H, SQ, D), (G, n_id, H, SQ, D)
        for combine in (False, True):
            inputs = [q_q if qmajor else q, k, v] + ([w] if combine else [])
            out[body.__name__, combine] = np.asarray(pl.pallas_call(
                functools.partial(body, n_id=n_id, sm_scale=SCALE, combine=combine),
                grid=(G, SQ // ROWS),
                in_specs=[qspec, kvspec, kvspec] + ([wspec] if combine else []),
                out_specs=qspec if combine else ospec_i,
                out_shape=jax.ShapeDtypeStruct(shape_c if combine else shape_i, jnp.float32),
                interpret=True)(*map(jnp.asarray, inputs)))
    out["_kernel_flat", True] = np.asarray(pl.pallas_call(
        functools.partial(jskv._kernel_flat, n_id=n_id, hpb=HPB, dh=D, sm_scale=SCALE),
        grid=(G, H // HPB, SQ // ROWS),
        in_specs=[pl.BlockSpec((1, ROWS, HPB * D), lambda gi, hp, qi: (gi, qi, hp)),
                  pl.BlockSpec((1, n_id, HPB, kk, D), lambda gi, hp, qi: (gi, 0, hp, 0, 0)),
                  pl.BlockSpec((1, n_id, HPB, kk, D), lambda gi, hp, qi: (gi, 0, hp, 0, 0)),
                  pl.BlockSpec((1, ROWS, n_id), lambda gi, hp, qi: (gi, qi, 0))],
        out_specs=pl.BlockSpec((1, ROWS, HPB * D), lambda gi, hp, qi: (gi, qi, hp)),
        out_shape=jax.ShapeDtypeStruct((G, SQ, H * D), jnp.float32),
        interpret=True)(*map(jnp.asarray, (q_f, k, v, w))))
    return dict(q=q, q_q=q_q, q_f=q_f, k=k, v=v, w=w), out


# kernel -> (the port's entry point, its q, combined, the TPU body, and the
# layout change from the body's output to the entry point's)
KERNELS = {
    "B2": ("short_kv_attention_flat", "q_f", False, "_kernel",
           lambda o: o.transpose(0, 1, 3, 2, 4).reshape(G, -1, SQ, H * D)),
    "B2h": ("short_kv_attention", "q", False, "_kernel", lambda o: o),
    "B2c": ("short_kv_attention_combined", "q", True, "_kernel", lambda o: o),
    "B14": ("short_kv_attention_qmajor", "q_q", False, "_kernel_qmajor", lambda o: o),
    "B14 combined": ("short_kv_attention_combined_qmajor", "q_q", True, "_kernel_qmajor",
                     lambda o: o),
    "B3": ("short_kv_attention_combined_flat", "q_f", True, "_kernel_flat", lambda o: o),
}


@pytest.mark.parametrize("n_id", IDS)
@pytest.mark.parametrize("kk", KS)
@pytest.mark.parametrize("kernel", list(KERNELS))
def test_plain_matches_tpu_body_at_tokens_and_ids(kernel, kk, n_id):
    """Each short-KV kernel's plain version against its TPU body in
    interpret mode at K tokens an identity and I identities."""
    fn, q_key, combine, body, layout = KERNELS[kernel]
    inputs, out = _jax_bodies(kk, n_id)
    args = [inputs[q_key], inputs["k"], inputs["v"]] + ([inputs["w"]] if combine else [])
    got = getattr(tskv, fn)(*to_torch(*args), SCALE)
    want = layout(out[body, combine])
    assert got.shape == want.shape
    if kernel == "B3":
        assert max_err(got, want) < 2e-5
    else:
        assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("kk,n_id", [(1, 1), (16, 3), (100, 5), (32, 8), (64, 64)])
def test_wrappers_take_any_tokens_and_ids(kk, n_id):
    """The wrappers' rule takes any K and I: on meta tensors (which no
    kernel takes) each passes it and refuses only the device, never the
    token or identity count."""
    meta = lambda *shape: torch.empty(shape, device="meta", dtype=torch.bfloat16)
    kv, w = meta(1, n_id, 2, kk, 64), meta(1, 64, n_id)
    for fn, args in ((tskv.short_kv_attention_combined_flat, (meta(1, 64, 128), kv, kv, w)),
                     (tskv.short_kv_attention_flat, (meta(1, 64, 128), kv, kv)),
                     (tskv.short_kv_attention_qmajor, (meta(1, 64, 2, 64), kv, kv)),
                     (tskv.short_kv_attention_combined_qmajor, (meta(1, 64, 2, 64), kv, kv, w)),
                     (tskv.short_kv_attention, (meta(1, 2, 64, 64), kv, kv)),
                     (tskv.short_kv_attention_combined, (meta(1, 2, 64, 64), kv, kv, w))):
        with pytest.raises(ValueError, match="contiguous bf16 CUDA"):
            fn(*args, 0.1)


def _create(cfg_mod, create, ids: int, face_tokens: int, audio_tokens: int):
    """`DiT.create` at the tiny tier's widths, face + audio, with `ids`
    identities, `face_tokens` LFE queries (the perceivers' keys an
    identity) and `audio_tokens` audio context tokens an identity; a router
    of one STAB layer, in either package (`create(cfg, audio, router,
    lfe)`)."""
    cfg = cfg_mod.tiny_dit_config(num_layers=2, num_ids=ids, lfe_num_tokens=face_tokens)
    audio = cfg_mod.AudioConfig(
        dim=cfg.inner_dim, audio_dim=16, blocks=2, intermediate_dim=16,
        context_tokens=audio_tokens, num_attention_heads=cfg.num_attention_heads,
        attention_head_dim=cfg.attention_head_dim,
        num_layers=cfg.num_layers // cfg.audio_attn_interval)
    router = cfg_mod.RouterConfig(num_layers=cfg.num_ca, q_k_dim=cfg.lfe_final_output_dim,
                                  num_id_token=face_tokens, num_heads=4, attn_heads=4,
                                  num_attention_layers=1)
    lfe = cfg_mod.LFEConfig(dim=32, depth=5, dim_head=8, heads=4, num_id_token=2,
                            num_queries=face_tokens, output_dim=cfg.lfe_final_output_dim,
                            id_embed_dim=24, vit_dim=16)
    return create(cfg, audio, router, lfe)


@pytest.mark.parametrize("ids,face_tokens,audio_tokens", [(3, 24, 16), (5, 56, 64)])
def test_created_dit_matches_jax_at_tokens_and_ids(ids, face_tokens, audio_tokens):
    """`DiT.create`'s face + audio DiT with I identities and K face / audio
    tokens (B2 at K_f, B3 at K_a with I identities' routing weights, the
    multi-ID STAB's general path at I != 2 on the card) against JAX's
    `DiT.apply` on the same weights and inputs."""
    jd = _create(jconfig, lambda c, a, r, lf: JDiT.create(c, r, a, lf), ids, face_tokens,
                 audio_tokens)
    td = _create(tconfig, lambda c, a, r, lf: DiT.create(c, a, r, lf, device="cpu"), ids,
                 face_tokens, audio_tokens)
    params = realistic(jax.eval_shape(jd.init, jax.random.key(0)), seed=8)
    td.load_state_dict(jax_params_to_torch(params), strict=True)
    c, a, lf = jd.cfg, jd.audio_cfg, jd.lfe_cfg
    assert (c.num_ids, td.cfg.lfe_num_tokens, td.audio_cfg.context_tokens) == (
        ids, face_tokens, audio_tokens)
    rng = np.random.default_rng(9)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    n_af = c.sample_frames + a.window_size - a.window_stride
    x = (f(1, c.latent_frames, c.in_channels, c.sample_height, c.sample_width),
         f(1, c.max_text_seq_length, c.text_embed_dim), np.array([321.0], np.float32))
    cond = dict(audio_embeds=f(1, ids, n_af, a.blocks, a.audio_dim),
                id_cond=f(1, ids, lf.id_embed_dim),
                id_vit_hidden=f(1, ids, lf.num_scales, 6, lf.vit_dim))
    rope = jd.rope(c.sample_height * 8, c.sample_width * 8, c.latent_frames)
    want, want_r = jax.jit(lambda p: jd.apply(p, *map(jnp.asarray, x), rope,
                                              **{k: jnp.asarray(v)
                                                 for k, v in cond.items()}))(params)
    with torch.no_grad():
        got, got_r = td.apply(*to_torch(*x),
                              td.rope(c.sample_height * 8, c.sample_width * 8, c.latent_frames),
                              **{k: to_torch(v)[0] for k, v in cond.items()})
    assert got_r.shape[-1] == ids
    assert _rel(got, np.asarray(want)) < 1e-5
    assert max_err(got_r, np.asarray(want_r)) < 1e-5

"""A 2-layer DiT at the head dims the flash kernels took last (16, 256, and
32 with heads that do not pair), against the JAX package on the CPU, fp32.

The cases, and the attention path each takes on the card:
  * 8 heads of 16 (hpb 8: the flat B7 path; audio only: the face path's
    widths need an inner dim whose 2/3 splits into the router's 4 heads);
  * 6 heads of 16 (the tiny tier's heads: B11 and B12 + B13 on the bshd
    view, face + audio);
  * 3 heads of 32 (they do not pair in 128 lanes: bshd, face + audio);
  * 2 heads of 256 (hpb 1: flat, audio only).
The tiny tier's audio layers take the DiT's own heads, as the
configuration that `DiT.create` derives does (B3 at the DiT's head dim on
the card: 16 and 32 above).  And `DiT.create` as phase 3g of
`chip_smoke.py` builds it, face + audio, with the audio configuration it
derives (32 audio tokens an identity) and a small router and LFE:
  * 3 heads of 128, with a router of 4 perceiver heads over 32 tokens and
    one STAB layer of one head of 128 (B3 at 128; B5, B8 and B4 at dh 128;
    one layer, not the tiny tier's two: JAX's compile of the face path's
    train step is most of the case's time).
Its audio projection's widths are cut (audio_dim 16, 2 blocks, 16 wide):
at the derived ones it holds 1.24 B parameters, which take a minute to
draw on the CPU.  `test_dit_create_derives_the_sub_configs` holds the
derivation itself against JAX's at the heads phase 3g runs.
At inference (`fuse_qk_norm`) only 3 x 128 takes the fused B1: JAX's module
takes it only at head dims 32, 64 and 128 with heads that pack.

For each, on the plain versions (what a CPU tensor takes):
  * the inference forward against JAX's `DiT.apply`, within 1e-5 of the
    output's magnitude (the routing logits 1e-5 absolute);
  * the train step's gradients and metrics (`Trainer.grads_and_metrics` of
    2 micro-batches on JAX's draws, what `train_step` computes before its
    update) against JAX's jitted `_grads_and_metrics`: loss and metrics
    within 1e-4 relative, the gradients together within relative L2 1e-5,
    each tensor within 1e-4 (a key bias, whose true gradient is 0, against
    its query twin's norm), as `tests/test_torch_head_dims.py` holds its
    12 x 32 and 3 x 128 cases, whose optimizer updates it also compares.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bindyouravatar_tpu import config as jconfig
from bindyouravatar_tpu.config import SchedulerConfig as JSchedulerConfig
from bindyouravatar_tpu.config import TrainConfig as JTrainConfig
from bindyouravatar_tpu.models.dit import DiT as JDiT
from bindyouravatar_tpu.ops.scheduler import Schedule as JSchedule
from bindyouravatar_tpu.training import trainer as jtrainer
from bindyouravatar_tpu_torch import config as tconfig
from bindyouravatar_tpu_torch.config import SchedulerConfig, TrainConfig
from bindyouravatar_tpu_torch.convert import jax_params_to_torch
from bindyouravatar_tpu_torch.models.dit import DiT
from bindyouravatar_tpu_torch.ops.scheduler import Schedule
from bindyouravatar_tpu_torch.training.trainer import Trainer
from test_torch_train_slice import _batch, jax_draws
from torch_port_utils import max_err, realistic, threads_per_worker, to_torch

# case -> (heads, head dim, face path on, None for `DiT.tiny` or, for
# `DiT.create` with the audio configuration derived, the router's (LFE
# tokens, perceiver heads, STAB heads))
CASES = {"8x16": (8, 16, False, None), "6x16": (6, 16, True, None),
         "3x32": (3, 32, True, None), "2x256": (2, 256, False, None),
         "create 3x128 stab 1x128": (3, 128, True, (32, 4, 1))}
CFG = dict(learning_rate=1e-3, lr_warmup_steps=0, max_train_steps=10)
FACE_KEYS = ("id_cond", "id_vit_hidden", "teacher_clean", "teacher_noisy")


@pytest.fixture(autouse=True, scope="module")
def _threads():
    with threads_per_worker():
        yield


def _rel(got, want) -> float:
    return max_err(got, want) / float(np.abs(np.asarray(want)).max())


def _create(cfg_mod, router, create, **kw):
    """`DiT.create` with a small router (`router`: LFE tokens, perceiver
    heads, STAB heads) and LFE, the audio configuration the port's
    `DiT.create` derives with its projection's widths cut, in either
    package (`create(cfg, audio, router, lfe)`)."""
    tokens, heads, attn_heads = router
    cfg = cfg_mod.tiny_dit_config(lfe_num_tokens=tokens, **kw)
    derived = DiT.create(tconfig.tiny_dit_config(lfe_num_tokens=tokens, **kw),
                         device="meta").audio_cfg
    audio = cfg_mod.AudioConfig(**{**dataclasses.asdict(derived), "audio_dim": 16, "blocks": 2,
                                   "intermediate_dim": 16})
    r = cfg_mod.RouterConfig(num_layers=cfg.num_ca, q_k_dim=cfg.lfe_final_output_dim,
                             num_id_token=tokens, num_heads=heads, attn_heads=attn_heads,
                             num_attention_layers=1)
    lf = cfg_mod.LFEConfig(dim=32, depth=5, dim_head=8, heads=4, num_id_token=2,
                           num_queries=tokens, output_dim=cfg.lfe_final_output_dim,
                           id_embed_dim=24, vit_dim=16)
    return create(cfg, audio, r, lf)


# case -> its numpy params, drawn once for the case's forward and train
# tests (`fuse_qk_norm` takes the same tree): JAX's init trace takes
# seconds a case
_PARAMS = {}


def _dits(case, fuse: bool):
    heads, d, face, router = CASES[case]
    kw = dict(num_attention_heads=heads, attention_head_dim=d, num_layers=2, lora_rank=4,
              is_train_face=face, fuse_qk_norm=fuse)
    if router is None:
        jd, td = JDiT.tiny(**kw), DiT.tiny(device="cpu", **kw)
    else:
        jd = _create(jconfig, router, lambda c, a, r, lf: JDiT.create(c, r, a, lf), **kw)
        td = _create(tconfig, router,
                     lambda c, a, r, lf: DiT.create(c, a, r, lf, device="cpu"), **kw)
        assert (td.audio_cfg.num_attention_heads, td.audio_cfg.attention_head_dim) == (heads, d)
        assert td.router_cfg.feat_dim // td.router_cfg.attn_heads == 128
    if case not in _PARAMS:
        _PARAMS[case] = realistic(jax.eval_shape(jd.init, jax.random.key(0)), seed=6)
    params = _PARAMS[case]
    td.load_state_dict(jax_params_to_torch(params), strict=True)
    return jd, params, td


@pytest.mark.parametrize("case", list(CASES))
def test_dit_inference_forward_matches_jax(case):
    """The inference path (`fuse_qk_norm=True`) of the 2-layer DiT against
    JAX's `DiT.apply`."""
    jd, params, td = _dits(case, fuse=True)
    c, a, lf = jd.cfg, jd.audio_cfg, jd.lfe_cfg
    rng = np.random.default_rng(7)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    n_af = c.sample_frames + a.window_size - a.window_stride
    x = (f(1, c.latent_frames, c.in_channels, c.sample_height, c.sample_width),
         f(1, c.max_text_seq_length, c.text_embed_dim), np.array([321.0], np.float32))
    cond = dict(audio_embeds=f(1, 2, n_af, a.blocks, a.audio_dim))
    if CASES[case][2]:
        cond.update(id_cond=f(1, c.num_ids, lf.id_embed_dim),
                    id_vit_hidden=f(1, c.num_ids, lf.num_scales, 6, lf.vit_dim))
    rope = jd.rope(c.sample_height * 8, c.sample_width * 8, c.latent_frames)
    want, want_r = jax.jit(lambda p: jd.apply(p, *map(jnp.asarray, x), rope,
                                              **{k: jnp.asarray(v)
                                                 for k, v in cond.items()}))(params)
    with torch.no_grad():
        got, got_r = td.apply(*to_torch(*x),
                              td.rope(c.sample_height * 8, c.sample_width * 8, c.latent_frames),
                              **{k: to_torch(v)[0] for k, v in cond.items()})
    # the created case is 4x the tiny tier's width (inner 384), with a
    # 32-token perceiver and a STAB head 128 wide (the tiny tier's: 8 tokens,
    # 8 wide), whose fp32 sums run in another order than JAX's: its output
    # and routing came within 0.88e-5 and 1.08e-5 of JAX's on a CPU, held to
    # 3e-5; the tiny tier's to 1e-5
    tol = 1e-5 if CASES[case][3] is None else 3e-5
    assert _rel(got, np.asarray(want)) < tol
    if want_r is not None:
        assert max_err(got_r, np.asarray(want_r)) < tol


@pytest.mark.parametrize("case", list(CASES))
def test_dit_train_step_matches_jax(case):
    """The train step's gradients and metrics (2 micro-batches) against
    JAX's on the same params, batch and draws."""
    jd, params, td = _dits(case, fuse=False)
    jcfg = JTrainConfig(**CFG)
    base = jtrainer.Trainer(dit=jd, schedule=JSchedule.create(JSchedulerConfig()), cfg=jcfg)
    batch = _batch(jd)
    if not CASES[case][2]:
        batch = {k: v for k, v in batch.items() if k not in FACE_KEYS}
    state, frozen = base.init_state(jax.tree.map(jnp.asarray, params))
    jgrads, jm = jax.jit(base._grads_and_metrics)(
        state.params, frozen, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(5))
    tr = Trainer(td, Schedule.create(SchedulerConfig()), TrainConfig(**CFG))
    grads, tm = tr.grads_and_metrics({k: torch.from_numpy(v) for k, v in batch.items()},
                                     jax_draws(jcfg, batch, jax.random.key(5), 2))
    assert set(tm) == set(jm)
    for k in jm:
        assert abs(float(tm[k]) - float(jm[k])) <= 1e-4 * max(abs(float(jm[k])), 1e-6), k
    want = jax_params_to_torch(jax.tree.map(np.asarray, jgrads))
    assert set(want) == set(grads)
    key_bias = ("to_k.bias", "norm_k.bias")
    for k, g in grads.items():
        ref = want[k.replace("_k.bias", "_q.bias")] if k.endswith(key_bias) else want[k]
        rel = float((g - want[k]).norm()) / max(float(ref.norm()), 1e-30)
        assert rel <= 1e-4, (k, rel)
    rest = [k for k in grads if not k.endswith(key_bias)]
    diff = sum(float((grads[k] - want[k]).double().square().sum()) for k in rest)
    norm = sum(float(want[k].double().square().sum()) for k in rest)
    assert (diff / norm) ** 0.5 <= 1e-5


@pytest.mark.parametrize("heads,d", [(24, 128), (96, 32), (192, 16), (12, 256), (48, 64)])
def test_dit_create_derives_the_sub_configs(heads, d):
    """The port's `DiT.create` derives the audio, router and LFE
    configurations as JAX's does (`bindyouravatar_tpu/models/dit.py:66-83`),
    at the full-width head splits of phase 3g (and the 5B's 48 x 64): the
    audio layers take the DiT's own heads, so kernel B3 runs at the DiT's
    head dim; the perceiver 16 heads of 128 over 32 tokens; the STAB 8 x 64
    over 512 channels."""
    kw = dict(num_attention_heads=heads, attention_head_dim=d, num_layers=42)
    jd = JDiT.create(jconfig.DiTConfig(**kw))
    td = DiT.create(tconfig.DiTConfig(**kw), device="meta")
    for name in ("audio_cfg", "router_cfg", "lfe_cfg"):
        assert dataclasses.asdict(getattr(td, name)) == dataclasses.asdict(getattr(jd, name)), name
    a, r = td.audio_cfg, td.router_cfg
    assert (a.num_attention_heads, a.attention_head_dim, a.dim, a.context_tokens) == (
        heads, d, 3072, 32)
    assert (r.q_k_dim // r.num_heads, r.num_id_token, r.feat_dim // r.attn_heads) == (128, 32, 64)

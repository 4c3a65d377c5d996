"""The port's training entry point against the JAX package's, on the CPU:
the VAE's encode, `TrainDriver.prepare_batch`, the driver's checkpoint and
exact resume, the sub-module files and the `sft` launcher, on the tiny
DiT and VAE.

The VAE runs on converted realistic-scale weights in fp32 on both sides:
latents within 1e-5 of the output's magnitude.  The host side of
`prepare_batch` (teacher masks, dense mask, the noised conditioning
image) is numpy fed from one numpy seed in JAX's order: equal bit for bit.
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bindyouravatar_tpu.config import SchedulerConfig as JSchedulerConfig
from bindyouravatar_tpu.config import TrainConfig as JTrainConfig
from bindyouravatar_tpu.config import VAEConfig as JVAEConfig
from bindyouravatar_tpu.models.dit import DiT as JDiT
from bindyouravatar_tpu.models.vae import CausalVAE as JCausalVAE
from bindyouravatar_tpu.ops.scheduler import Schedule as JSchedule
from bindyouravatar_tpu.training import train_loop as jloop
from bindyouravatar_tpu.training import trainer as jtrainer
from bindyouravatar_tpu_torch.config import SchedulerConfig, TrainConfig
from bindyouravatar_tpu_torch.convert import jax_params_to_torch
from bindyouravatar_tpu_torch.models import vae as tvae
from bindyouravatar_tpu_torch.models.dit import DiT
from bindyouravatar_tpu_torch.models.vae import CausalVAE
from bindyouravatar_tpu_torch.ops.scheduler import Schedule
from bindyouravatar_tpu_torch.training import checkpoint as ckpt
from bindyouravatar_tpu_torch.training import sft
from bindyouravatar_tpu_torch.training import train_loop as tloop
from bindyouravatar_tpu_torch.training.data import SyntheticAvatarDataset, collate
from bindyouravatar_tpu_torch.training.trainer import Trainer
from torch_port_utils import max_err, realistic, threads_per_worker


@pytest.fixture(autouse=True, scope="module")
def _threads():
    """Torch's threads at this xdist worker's share of the cores."""
    with threads_per_worker():
        yield


def _rel(got, want) -> float:
    return max_err(got, want) / max(1.0, float(np.abs(np.asarray(want)).max()))


@pytest.fixture(scope="module")
def vaes():
    """The tiny VAE (the JAX driver tests' config) on realistic weights."""
    jv = JCausalVAE(JVAEConfig(block_out_channels=(8, 8, 16, 16), layers_per_block=1,
                               latent_channels=4, norm_num_groups=4, dtype=jnp.float32))
    params = realistic(jax.eval_shape(jv.init, jax.random.key(1)), seed=6)
    tv = CausalVAE.tiny(device="cpu")
    tv.load_state_dict(jax_params_to_torch(params), strict=True)
    return jv, params, tv


def test_encode_matches_jax(vaes):
    """Moments, the mode, the chunked encode with its 2 latent frames of
    context, and the sampled form: mean + exp(clip(logvar) / 2) * eps."""
    jv, params, tv = vaes
    video = np.random.default_rng(2).uniform(-1, 1, (1, 17, 3, 32, 48)).astype(np.float32)
    jvideo, tvideo = jnp.asarray(video), torch.from_numpy(video)
    with torch.no_grad():
        moments = tv.encode_moments(tvideo)
        mode = tv.encode(tvideo)
        chunked = tv.encode(tvideo, temporal_chunk=2)
        sampled = tv.encode(tvideo, sample=True, generator=torch.Generator().manual_seed(3))
    jmoments = np.asarray(jv.encode_moments(params, jvideo))
    assert moments.shape == (1, 5, 8, 4, 6)
    assert _rel(moments, jmoments) < 1e-5
    assert _rel(mode, jv.encode(params, jvideo)) < 1e-5
    assert _rel(chunked, jv.encode(params, jvideo, temporal_chunk=2)) < 1e-5
    assert _rel(chunked, mode) > 1e-4                    # the joins are approximate

    mean, logvar = torch.from_numpy(jmoments.copy()).chunk(2, dim=2)
    std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0))
    scale = tv.cfg.scaling_factor
    eps = torch.randn(mean.shape, generator=torch.Generator().manual_seed(3))
    assert _rel(sampled, (mean + std * eps) * scale) < 1e-5
    key = jax.random.key(4)           # JAX's sampled form, given its own eps
    jeps = torch.from_numpy(np.array(jax.random.normal(key, mean.shape, jnp.float32)))
    assert _rel((mean + std * jeps) * scale, jv.encode(params, jvideo, key=key, sample=True)) < 1e-5
    with pytest.raises(ValueError, match="generator"):
        tv.encode(tvideo, sample=True)


def test_sliced_vae_ops_compute_the_same_function(vaes, monkeypatch):
    """Without autograd, group norms and causal convs above `SLICE_ELEMENTS`
    run a slice at a time: with a limit small enough to slice every op of
    the tiny VAE, encode and decode agree with the one-pass ops within 1e-5
    (fp32; the sliced group norm sums its statistics in another order)."""
    _, _, tv = vaes
    rng = np.random.default_rng(8)
    video = torch.from_numpy(rng.uniform(-1, 1, (1, 9, 3, 32, 48)).astype(np.float32))
    latents = torch.from_numpy(rng.standard_normal((1, 3, 4, 4, 6)).astype(np.float32))
    with torch.no_grad():
        whole = tv.encode(video), tv.decode(latents)
        monkeypatch.setattr(tvae, "SLICE_ELEMENTS", 1500)
        sliced = tv.encode(video), tv.decode(latents)
    for got, want in zip(sliced, whole):
        assert got.shape == want.shape
        assert _rel(got, want.numpy()) < 1e-5


class _Recorder:
    """A VAE whose `encode` records its video input (the noised
    conditioning image is the last call's)."""

    def __init__(self, vae, jax_side):
        self.vae, self.jax_side, self.inputs = vae, jax_side, []

    def __getattr__(self, name):
        return getattr(self.vae, name)

    def encode(self, *args, **kw):
        x = args[1] if self.jax_side else args[0]
        self.inputs.append(np.asarray(x))
        return self.vae.encode(*args, **kw)


def _drivers(vaes, tmp_path, in_channels=8, **cfg):
    """(JAX driver, port driver) over the tiny DiT, recording VAEs."""
    jv, params, tv = vaes
    jd = JDiT.tiny(lora_rank=0, in_channels=in_channels, out_channels=4)
    jtr = jtrainer.Trainer(dit=jd, schedule=JSchedule.create(JSchedulerConfig()),
                           cfg=JTrainConfig(**cfg))
    jdrv = jloop.TrainDriver(trainer=jtr, vae=_Recorder(jv, True), vae_params=params,
                             cfg=jtr.cfg, output_dir=str(tmp_path / "jax"))
    td = DiT.tiny(device="cpu", generator=torch.Generator().manual_seed(0), lora_rank=0,
                  in_channels=in_channels, out_channels=4)
    ttr = Trainer(td, Schedule.create(SchedulerConfig()), TrainConfig(**cfg))
    tdrv = tloop.TrainDriver(trainer=ttr, vae=_Recorder(tv, False), cfg=ttr.cfg,
                             output_dir=str(tmp_path / "port"), device="cpu")
    return jdrv, tdrv


def _sample(dit_cfg, n=2):
    ds = SyntheticAvatarDataset(length=4, num_frames=dit_cfg.sample_frames,
                                height=dit_cfg.sample_height * 8,
                                width=dit_cfg.sample_width * 8, audio_blocks=2, audio_dim=16)
    return collate([ds[i] for i in range(n)])


def _extras(c, b=2):
    rng = np.random.default_rng(5)
    return dict(text_embeds=rng.standard_normal((b, c.max_text_seq_length, c.text_embed_dim))
                .astype(np.float32),
                id_cond=rng.standard_normal((b, c.num_ids, 24)).astype(np.float32),
                id_vit_hidden=rng.standard_normal((b, c.num_ids, 5, 9, 16)).astype(np.float32))


@pytest.mark.parametrize("stochastic", [True, False])
def test_prepare_batch_matches_jax(vaes, tmp_path, stochastic):
    """From one numpy seed: the teacher masks, the dense mask and the noised
    conditioning image equal JAX's bit for bit and both generators end in
    the same state (the draws were taken in the same order); the latents
    are within 1e-5 where the encode is the mode (a sampled encode draws
    eps from each side's own generator)."""
    jdrv, tdrv = _drivers(vaes, tmp_path, stochastic_vae=stochastic)
    sample = _sample(tdrv.trainer.dit.cfg)
    extras = _extras(tdrv.trainer.dit.cfg)
    rj, rt = np.random.default_rng(9), np.random.default_rng(9)
    want = jdrv.prepare_batch(sample, rj, **extras)
    got = tdrv.prepare_batch(sample, rt, **extras)
    assert rj.bit_generator.state == rt.bit_generator.state
    for k in ("teacher_clean", "teacher_noisy", "dense_mask", "af_matrix", "prompt_embeds",
              "audio_embeds", "id_cond", "id_vit_hidden"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert len(jdrv.vae.inputs) == len(tdrv.vae.inputs) == 3      # 2 clips, then the image
    np.testing.assert_array_equal(tdrv.vae.inputs[-1], jdrv.vae.inputs[-1])
    assert not np.array_equal(tdrv.vae.inputs[-1], sample["video"][:, :1])
    assert set(got) - set(want) == set() and "bg_latents" not in got
    for k in ("video_latents", "image_latents"):
        assert got[k].shape == want[k].shape
        close = _rel(got[k], want[k]) < 1e-5
        assert close != stochastic, k
    assert float(got["image_latents"][:, 1:].abs().max()) == 0.0


def test_noised_conditioning_image_equals_jax():
    rng = np.random.default_rng(1)
    img = rng.uniform(-1, 1, (2, 1, 3, 8, 12)).astype(np.float32)
    mask = (rng.random((2, 8, 12)) > 0.5).astype(np.float32)
    for m, mean in ((mask, -1.0), (None, -3.0)):
        got = tloop.noised_conditioning_image(img, m, np.random.default_rng(4), mean, 0.5)
        want = jloop.noised_conditioning_image(img, m, np.random.default_rng(4), mean, 0.5)
        np.testing.assert_array_equal(got, want)


def test_background_block_of_the_5b_layout(vaes, tmp_path):
    """A DiT with in_channels = 3 x out_channels (the 5B layout: noise,
    image and background latents).  JAX's `prepare_batch` builds no
    `bg_latents`, so JAX's loss fails on the patch embed's shape; the
    port's fills the block with zeros, the pipeline's convention, and a
    train step runs."""
    jdrv, tdrv = _drivers(vaes, tmp_path, in_channels=12, lr_scheduler="constant",
                          learning_rate=1e-3)
    sample = _sample(tdrv.trainer.dit.cfg)
    extras = _extras(tdrv.trainer.dit.cfg)
    jbatch = jdrv.prepare_batch(sample, np.random.default_rng(0), **extras)
    assert "bg_latents" not in jbatch
    jtr = jdrv.trainer
    shapes = jax.eval_shape(jtr.dit.init, jax.random.key(0))
    with pytest.raises(Exception, match="shape"):
        jax.eval_shape(jtr.loss_and_metrics, shapes, jbatch, jax.random.key(1))

    batch = tdrv.prepare_batch(sample, np.random.default_rng(0), **extras)
    assert torch.equal(batch["bg_latents"], torch.zeros_like(batch["video_latents"]))
    tr = tdrv.trainer
    state = tr.init_state()
    before = {k: p.detach().clone() for k, p in tr.trainable.items()}
    state, metrics = tr.train_step(state, batch, generator=torch.Generator().manual_seed(0))
    assert state.step == 1 and all(math.isfinite(float(v)) for v in metrics.values())
    assert any(not torch.equal(before[k], p) for k, p in tr.trainable.items())


def _port_driver(tmp_path, name, **cfg):
    cfg = TrainConfig(**{**dict(learning_rate=1e-3, lr_warmup_steps=1, max_train_steps=4,
                                checkpointing_steps=2, checkpoints_total_limit=2), **cfg})
    g = torch.Generator().manual_seed(0)
    dit = DiT.tiny(device="cpu", generator=g, lora_rank=2, in_channels=8, out_channels=4)
    vae = CausalVAE.tiny(device="cpu", generator=g)
    return tloop.TrainDriver(trainer=Trainer(dit, Schedule.create(SchedulerConfig()), cfg),
                             vae=vae, cfg=cfg, output_dir=str(tmp_path / name), device="cpu")


def _run(driver, steps, resume, seen=None):
    c = driver.trainer.dit.cfg
    ds = SyntheticAvatarDataset(length=6, num_frames=c.sample_frames,
                                height=c.sample_height * 8, width=c.sample_width * 8,
                                audio_blocks=2, audio_dim=16)
    return driver.run(ds, max_steps=steps, resume=resume,
                      make_batch_extras=lambda s: _extras(c, s["video"].shape[0]),
                      resume_fn=None if seen is None else lambda d, st: seen.append(st.step))


def test_resumed_run_equals_an_uninterrupted_run(tmp_path):
    """4 steps against 2 steps, then a new driver (new models from the same
    init) resumed for 2 more: the same trainable tensors, AdamW moments,
    EMA, metrics and host state, bit for bit (the sampler crosses an epoch
    at step 4; EMA and the two-group LR on)."""
    extra = dict(ema_decay=0.9, is_diff_lr=True)
    full = _port_driver(tmp_path, "full", **extra)
    s_full = _run(full, 4, None)
    _run(_port_driver(tmp_path, "cut", **extra), 2, None)
    seen = []
    resumed = _port_driver(tmp_path, "cut", **extra)
    s_res = _run(resumed, 4, "latest", seen)
    assert seen == [2] and s_full.step == s_res.step == 4 and s_full.count == 4
    for k, p in full.trainer.trainable.items():
        assert torch.equal(p, resumed.trainer.trainable[k]), k
        for name in ("mu", "nu", "ema"):
            assert torch.equal(getattr(s_full, name)[k], getattr(s_res, name)[k]), (name, k)
    assert full.host_state()["sampler"] == resumed.host_state()["sampler"] == \
        {"epoch": 1, "cursor": 2, "seed": full.cfg.seed}
    assert full.host_state()["np_rng"] == resumed.host_state()["np_rng"]
    assert torch.equal(full.host_state()["torch_rng"], resumed.host_state()["torch_rng"])
    rows = {}
    for name in ("full", "cut"):
        with open(tmp_path / name / "metrics.jsonl") as f:
            rows[name] = [json.loads(line) for line in f]
    drop = ("step_time_s", "prepare_batch_s")
    strip = lambda r: {k: v for k, v in r.items() if k not in drop}
    assert [strip(r) for r in rows["full"]] == [strip(r) for r in rows["cut"]]
    assert [r["step"] for r in rows["cut"]] == [1, 2, 3, 4]
    # the EMA is what the sub-module files export
    sub = torch.load(tmp_path / "full" / "modules-4" / "face_modules.pt", weights_only=True)
    name = next(k for k in sub if k.startswith("perceivers."))
    assert torch.equal(sub[name], s_full.ema[name])
    assert not torch.equal(sub[name], full.trainer.trainable[name])


def test_checkpoint_rotation_and_partial_saves(tmp_path):
    """`total_limit` keeps the newest steps; a save that did not finish (its
    temporary directory) is never the latest; a restore returns what was
    saved."""
    d = str(tmp_path / "ck")
    assert ckpt.latest_step(d) is None
    for step in (1, 2, 3, 5):
        ckpt.save_checkpoint(d, step, {"x": torch.full((3,), float(step)), "meta": {"s": step}},
                             total_limit=2)
    assert sorted(os.listdir(d)) == ["3", "5"] and ckpt.latest_step(d) == 5
    os.makedirs(os.path.join(d, ".tmp-7-1"))
    with open(os.path.join(d, ".tmp-7-1", "state.pt"), "wb") as f:
        f.write(b"partial")
    os.makedirs(os.path.join(d, "9"))                     # a step directory with no state
    assert ckpt.latest_step(d) == 5
    payload = ckpt.restore_checkpoint(d)
    assert torch.equal(payload["x"], torch.full((3,), 5.0)) and payload["meta"] == {"s": 5}
    assert ckpt.restore_checkpoint(d, 3)["meta"] == {"s": 3}
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(str(tmp_path / "none"))


def test_submodules_round_trip(tmp_path):
    """`modules-{step}/{audio,face,router}_modules.pt` from one DiT load into
    another: their groups' tensors replaced, every other tensor kept."""
    a = DiT.tiny(device="cpu", generator=torch.Generator().manual_seed(1))
    b = DiT.tiny(device="cpu", generator=torch.Generator().manual_seed(2))
    named = dict(a.named_parameters())
    ckpt.save_submodules(named, str(tmp_path / "m"))
    assert sorted(os.listdir(tmp_path / "m")) == [
        "audio_modules.pt", "face_modules.pt", "router_modules.pt"]
    prefixes = tuple(p for group in ckpt.SUBMODULE_KEYS.values() for p in group)
    mine = b.state_dict()
    merged = ckpt.load_submodules(mine, str(tmp_path / "m"))
    b.load_state_dict(merged, strict=True)
    for k, v in b.state_dict().items():
        if k.startswith(prefixes):
            assert torch.equal(v, named[k].detach()), k
        else:
            assert torch.equal(v, mine[k]), k
    only_audio = ckpt.load_submodules(mine, str(tmp_path / "m"), names=["audio"])
    assert torch.equal(only_audio["router_trunk.final_proj.weight"],
                       mine["router_trunk.final_proj.weight"])
    assert sum(k.startswith("lfe.") for k in named) > 0


def test_sft_launcher_tiny_on_the_cpu(tmp_path):
    """`python -m bindyouravatar_tpu_torch.training.sft --model_size tiny
    --device cpu`: 2 steps, a checkpoint each, finite metrics, the
    sub-module files; a second call resumes at the latest step."""
    out = str(tmp_path / "sft")
    argv = ["--model_size", "tiny", "--device", "cpu", "--output_dir", out,
            "--checkpointing_steps", "1", "--checkpoints_total_limit", "1", "--seed", "3"]
    run = sft.main(argv + ["--max_train_steps", "2"])
    assert run.state.step == 2
    with open(os.path.join(out, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows] == [1, 2]
    assert all(math.isfinite(v) for r in rows for v in r.values())
    assert os.listdir(os.path.join(out, "checkpoints")) == ["2"]
    assert os.path.isfile(os.path.join(out, "modules-2", "router_modules.pt"))
    seen = []
    again = sft.main(argv + ["--max_train_steps", "3"], resume_fn=lambda d, s: seen.append(s.step))
    assert seen == [2] and again.state.step == 3


@pytest.mark.parametrize("flags,item", [
    (["--index_file", "x.txt"], "A 13"), (["--reference_transformer", "a.safetensors"], "A 13"),
    (["--fsdp", "2"], "A 12"), (["--num_validation_videos", "1"], "A 13"),
    (["--optimizer", "prodigy"], "A 5"), (["--use_8bit_adam"], "A 5"),
])
def test_sft_launcher_refuses_what_is_not_ported(flags, item):
    with pytest.raises(NotImplementedError, match=item):
        sft.main(["--device", "cpu"] + flags)


def test_entry_points_raise_without_a_gpu(tmp_path):
    """The launcher and the driver run on the card unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        sft.main(["--model_size", "tiny", "--output_dir", str(tmp_path)])
    tr = Trainer(DiT.tiny(device="cpu"), Schedule.create(SchedulerConfig()), TrainConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        tloop.TrainDriver(trainer=tr, vae=None, cfg=TrainConfig(), output_dir=str(tmp_path))

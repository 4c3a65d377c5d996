"""The port's CLI and its host-side inputs on the CPU.

`pipeline.generate(return_routing=True)` against JAX's on the tiny face
DiT (fed JAX's initial latents and SDE noise): the final latents within
1e-5 of their magnitude, the routing [steps, num_ca, B, S, I] in bf16
within one bf16 ulp at 1.0 (2^-8: fp32 differences may round a value to
the neighbouring bf16), under both `cfg_microbatch` settings, and None
with the face path off.  The host-side copies (`load_precomputed`, the wav
reader and mix, `masks_to_routing_logits`) against JAX's on the same files,
bit for bit.  `python -m bindyouravatar_tpu_torch.infer` end to end at
`--model_size tiny --device cpu`, from drawn weights and from a checkpoint
of the port's trainer, and its refusals.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from bindyouravatar_tpu.config import PipelineConfig as JPipelineConfig
from bindyouravatar_tpu.config import VAEConfig as JVAEConfig
from bindyouravatar_tpu.models.dit import DiT as JDiT
from bindyouravatar_tpu.models.vae import CausalVAE as JCausalVAE
from bindyouravatar_tpu.pipeline.pipeline import BindYourAvatarPipeline as JPipeline
from bindyouravatar_tpu.preprocess import audio as jaudio
from bindyouravatar_tpu.utils import masks as jmasks
from bindyouravatar_tpu.utils import media as jmedia
from bindyouravatar_tpu_torch import infer
from bindyouravatar_tpu_torch.config import PipelineConfig
from bindyouravatar_tpu_torch.convert import jax_params_to_torch
from bindyouravatar_tpu_torch.models.dit import DiT
from bindyouravatar_tpu_torch.models.vae import CausalVAE
from bindyouravatar_tpu_torch.pipeline.pipeline import BindYourAvatarPipeline
from bindyouravatar_tpu_torch.preprocess import audio as taudio
from bindyouravatar_tpu_torch.training import sft
from bindyouravatar_tpu_torch.utils import masks as tmasks
from bindyouravatar_tpu_torch.utils import media as tmedia
from torch_port_utils import max_err, realistic, threads_per_worker

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets")
STEPS = 2
TINY = ["--model_size", "tiny", "--device", "cpu", "--num_frames", "9", "--height", "128",
        "--width", "192", "--num_inference_steps", str(STEPS)]
AUDIO = [os.path.join(ASSETS, "audio_emb", f"000_{i}.pt") for i in (0, 1)]



@pytest.fixture(autouse=True, scope="module")
def _threads():
    with threads_per_worker():
        yield

@pytest.fixture(scope="module")
def models():
    jd = JDiT.tiny()
    jv = JCausalVAE(JVAEConfig(block_out_channels=(8, 8, 16, 16), layers_per_block=1,
                               latent_channels=4, norm_num_groups=4, dtype=jnp.float32))
    dp = realistic(jax.eval_shape(jd.init, jax.random.key(0)), seed=1)
    vp = realistic(jax.eval_shape(jv.init, jax.random.key(1)), seed=2)
    td, tv = DiT.tiny(device="cpu"), CausalVAE.tiny(device="cpu")
    td.load_state_dict(jax_params_to_torch(dp), strict=True)
    tv.load_state_dict(jax_params_to_torch(vp), strict=True)
    return jd, jv, dp, vp, td.eval(), tv.eval()


@pytest.mark.parametrize("case", ["batch-2 CFG", "cfg_microbatch", "face off"])
def test_return_routing_matches_jax(models, case):
    """The cond half's routing of every step, [steps, num_ca, B, S, I]
    bf16, beside the final latents; None when no face tokens are given."""
    jd, jv, dp, vp, td, tv = models
    c, a, lf = jd.cfg, jd.audio_cfg, jd.lfe_cfg
    kw = dict(height=c.sample_height * 8, width=c.sample_width * 8, num_frames=c.sample_frames,
              num_inference_steps=STEPS, cfg_microbatch=case == "cfg_microbatch")
    jp = JPipeline.create(jd, jv, JPipelineConfig(**kw))
    tp = BindYourAvatarPipeline.create(td, tv, PipelineConfig(**kw))
    rng = np.random.default_rng(9)
    f32 = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    prompt, neg = f32(1, c.max_text_seq_length, c.text_embed_dim), np.zeros(
        (1, c.max_text_seq_length, c.text_embed_dim), np.float32)
    image = rng.uniform(-1, 1, (1, 1, 3, c.sample_height * 8, c.sample_width * 8)).astype(
        np.float32)
    latents = f32(1, c.latent_frames, 4, c.sample_height, c.sample_width)
    cond = dict(audio_embeds=f32(1, 2, c.sample_frames + a.window_size - a.window_stride,
                                 a.blocks, a.audio_dim))
    if case != "face off":
        cond.update(id_cond=f32(1, c.num_ids, lf.id_embed_dim),
                    id_vit_hidden=f32(1, c.num_ids, lf.num_scales, 6, lf.vit_dim))
    key = jax.random.key(7)
    jlat, jr = jp.generate({"dit": dp, "vae": vp}, jnp.asarray(prompt), jnp.asarray(neg),
                           jnp.asarray(image), key, decode=False, return_routing=True,
                           latents=jnp.asarray(latents),
                           **{k: jnp.asarray(v) for k, v in cond.items()})
    # the JAX loop's SDE noise: key -> (carry, init) split, then one split per step
    k, noise = jax.random.split(key)[0], []
    for _ in range(STEPS):
        k, k_noise = jax.random.split(k)
        noise.append(torch.from_numpy(np.array(jax.random.normal(k_noise, latents.shape))))
    t = torch.from_numpy
    tlat, tr = tp.generate(t(prompt), t(neg), t(image), torch.Generator().manual_seed(0),
                           decode=False, return_routing=True, latents=t(latents), noise=noise,
                           **{k: t(v) for k, v in cond.items()})
    assert max_err(tlat, jlat) / float(np.abs(np.asarray(jlat)).max()) < 1e-5
    if case == "face off":
        assert tr is None and jr is None
        return
    assert tr.dtype == torch.bfloat16 and jr.dtype == jnp.bfloat16
    assert tuple(tr.shape) == jr.shape == (STEPS, c.num_ca, 1, c.video_seq_len, c.num_ids)
    assert max_err(tr.float(), np.asarray(jr, np.float32)) <= 2.0 ** -8


def _write_masks(directory, frames=9, h=128, w=192, seed=0):
    """A SAM2 mask directory: {1,2}/annotated_frame_%05d.png, one moving
    blob per identity (grey levels, so the resize's > 0.5 decides)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    for ident, x0 in ((1, w // 4), (2, 3 * w // 4)):
        d = os.path.join(directory, str(ident))
        os.makedirs(d, exist_ok=True)
        for f in range(frames):
            cx, cy = x0 + 2 * f, h // 2 + rng.integers(-4, 5)
            blob = np.clip(1.5 - np.hypot((xx - cx) / 30, (yy - cy) / 40), 0, 1)
            Image.fromarray((blob * 255).astype(np.uint8)).save(
                os.path.join(d, f"annotated_frame_{f:05d}.png"))
    return directory


@pytest.mark.parametrize("what", ["load_precomputed", "wav", "masks_to_routing_logits"])
def test_host_inputs_equal_jax(what, tmp_path):
    """The port's copies of JAX's host-side readers give the same arrays
    from the same files, bit for bit."""
    if what == "load_precomputed":
        bf = str(tmp_path / "bf16.pt")
        torch.save(torch.randn(13, 2, 16, generator=torch.Generator().manual_seed(0)).to(
            torch.bfloat16), bf)
        for path in AUDIO + [os.path.join(ASSETS, "audio_emb", "ae_mute.pt"), bf]:
            got, want = taudio.load_precomputed(path), jaudio.load_precomputed(path)
            assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)
    elif what == "wav":
        wavs = [os.path.join(ASSETS, "audio", f"000_{i}.wav") for i in (0, 1)]
        a, b = (taudio.read_wav_mono_16k(p) for p in wavs)
        assert np.array_equal(a, jaudio.read_wav_mono_16k(wavs[0]))
        assert np.array_equal(taudio.mix_tracks(a, b), jaudio.mix_tracks(a, b))
        tmedia.merge_audio_files(wavs, str(tmp_path / "t.wav"))
        jmedia.merge_audio_files(wavs, str(tmp_path / "j.wav"))
        assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    else:
        d = _write_masks(str(tmp_path / "masks"))
        for grid in ((3, 8, 12), (13, 30, 45)):
            got = tmasks.masks_to_routing_logits(d, *grid)
            want = jmasks.masks_to_routing_logits(d, *grid)
            assert got.shape == (1, int(np.prod(grid)), 2) and np.array_equal(got, want)
            assert 0 < got[..., 0].sum() and 0 < got[..., 1].sum()


def test_save_routing_debug_writes_num_ca_plus_one_videos(tmp_path, capsys):
    r = np.random.default_rng(0).uniform(0, 1, (3, 2, 1, 2 * 4 * 6, 2)).astype(np.float32)
    infer.save_routing_debug(r, (2, 4, 6), str(tmp_path), fps=5)
    dbg = tmp_path / "routing_logits"
    assert sorted(os.listdir(dbg)) == ["final_step_layer00.mp4", "final_step_layer01.mp4",
                                       "mean_over_steps_layers.mp4"]
    assert all(os.path.getsize(dbg / f) > 0 for f in os.listdir(dbg))
    infer.save_routing_debug(None, (2, 4, 6), str(tmp_path / "none"), fps=5)
    assert "face/router path is off" in capsys.readouterr().err
    assert not (tmp_path / "none").exists()


@pytest.mark.parametrize("case", ["two tracks, bg frame, forced routing, two-stage",
                                  "one track + mute, embeddings, wav mux, routing"])
def test_cli_end_to_end_on_the_cpu(case, tmp_path, capsys, monkeypatch):
    """`infer.main` writes the clip and prints the meta line; one
    `generate`, given the bg frame and `--tracking_mask_dir`'s routing."""
    out = tmp_path / "out"
    argv = TINY + ["--output_dir", str(out)]
    if case.startswith("two tracks"):
        argv += ["--audio_path"] + AUDIO + [
            "--inpaintingframe_path", os.path.join(ASSETS, "inpaintingframe", "000.png"),
            "--tracking_mask_dir", _write_masks(str(tmp_path / "masks")),
            "--two_stage_generate"]
    else:
        rng = np.random.default_rng(1)
        for name in ("pe", "ne"):
            np.save(tmp_path / f"{name}.npy", rng.standard_normal((1, 8, 32)).astype(np.float32))
        argv += ["--audio_path", AUDIO[0], "--speaker_pos", "right",
                 "--mute_audio_path", os.path.join(ASSETS, "audio_emb", "ae_mute.pt"),
                 "--prompt_embeds", str(tmp_path / "pe.npy"),
                 "--negative_prompt_embeds", str(tmp_path / "ne.npy"),
                 "--wav_path"] + [os.path.join(ASSETS, "audio", f"000_{i}.wav") for i in (0, 1)] + [
                 "--draw_routing_logits"]
    seen, generate = [], BindYourAvatarPipeline.generate
    monkeypatch.setattr(BindYourAvatarPipeline, "generate",
                        lambda self, *a, **kw: seen.append(kw) or generate(self, *a, **kw))
    path = infer.main(argv)
    meta = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert meta["output"] == path and meta["frames"] == 9 and meta["steps"] == STEPS
    assert os.path.isfile(path) and os.path.getsize(path) > 0
    if case.startswith("two tracks"):
        # the masks reach generate as the forced routing (with no face
        # tokens it leaves the clip as it is, as in JAX)
        want = tmasks.masks_to_routing_logits(str(tmp_path / "masks"), 3, 8, 12)
        assert np.array_equal(seen[0]["routing_forcing"].numpy(), want)
        assert seen[0]["image_bg"] is not None and len(seen) == 1
    else:
        assert path.endswith("output_av.mp4") and (out / "mixed.wav").is_file()


def test_cli_serves_a_checkpoint_of_the_ports_trainer(tmp_path):
    """A `training.sft` run's checkpoint served by the CLI: the CLI's DiT
    (drawn from the same seed, the checkpoint's trainable tensors and LoRA
    rank restored) equals the trained one tensor for tensor; then the clip."""
    run_dir = str(tmp_path / "sft")
    trained = sft.main(["--model_size", "tiny", "--device", "cpu", "--output_dir", run_dir,
                        "--max_train_steps", "2", "--checkpointing_steps", "2"]).driver.trainer
    args = infer.get_args(TINY + ["--checkpoint_dir", run_dir, "--output_dir",
                                  str(tmp_path / "out"), "--audio_path"] + AUDIO)
    trainable = infer.restore_trainable(args.checkpoint_dir)
    assert set(trainable) == set(trained.trainable)
    pipe = infer.build_models(args, torch.device("cpu"), lora_rank=8)
    infer.load_params(pipe, args, trainable)
    want = dict(trained.dit.named_parameters())
    got = dict(pipe.dit.named_parameters())
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    # LoRA's B is drawn as zeros: equal to the trained B, the restore took
    assert any(bool(t.abs().sum() > 0) for k, t in trainable.items() if k.endswith("lora_B"))
    res = infer.run(args)
    assert res.video.shape == (1, 9, 3, 128, 192) and np.isfinite(res.video).all()


@pytest.fixture(scope="module")
def face_files(tmp_path_factory):
    """Reference-format files of the face stack's nets and a T5 directory
    (`test_torch_face_stack`'s and `test_torch_encoders`' writers)."""
    from test_torch_encoders import make_t5_dir
    from test_torch_face_stack import write_face_checkpoints

    pytest.importorskip("transformers")
    d = tmp_path_factory.mktemp("face_files")
    make_t5_dir(str(d / "t5"))
    return {**write_face_checkpoints(d), "t5": str(d / "t5")}


FACE_IMGS = [os.path.join(ASSETS, "faces", f"000_{i}.png") for i in (0, 1)]


@pytest.mark.parametrize("flag", ["--img_file_path", "--retinaface_checkpoint",
                                  "--bisenet_checkpoint", "--arcface_checkpoint", "--t5_dir"])
def test_cli_takes_the_face_and_t5_flags(flag, face_files):
    """What each flag the CLI refused before the face stack was ported does
    to `encode_conditioning` (the tiny tier on the CPU): the two images give
    `id_cond` [1, 2, 512 + 16], `id_vit_hidden` [1, 2, 5, 5, 32] and a
    canvas holding the faces (other than 1 or 3 images raise); RetinaFace
    aligns the faces to its landmarks, so the canvas changes; BiSeNet whites
    out the background labels; IR-100's embedding replaces the unit-norm
    `HashEmbedder`'s; `--t5_dir` gives the prompt and the negative prompt
    embeddings [1, 8, 32], `encode_prompts`' own."""
    from bindyouravatar_tpu_torch.models.t5 import encode_prompts, load_t5_encoder

    dev = torch.device("cpu")
    args = lambda *extra: infer.get_args(TINY + list(extra))
    base = infer.encode_conditioning(args("--img_file_path", *FACE_IMGS), dev)
    if flag == "--img_file_path":
        assert base["id_cond"].shape == (1, 2, 528)
        assert base["id_vit_hidden"].shape == (1, 2, 5, 5, 32)
        assert base["canvas"].shape == (128, 192, 3) and (base["canvas"] != 255).any()
        assert np.all(np.isfinite(base["id_cond"])) and "pe" not in base
        for n in (1, 3):
            with pytest.raises(ValueError, match="exactly 2"):
                infer.encode_conditioning(args("--img_file_path", *(FACE_IMGS * 2)[:n]), dev)
        return
    if flag == "--t5_dir":
        out = infer.encode_conditioning(args("--t5_dir", face_files["t5"], "--prompt",
                                             "two people talking", "--negative_prompt",
                                             "blurry"), dev)
        assert "id_cond" not in out and out["pe"].shape == out["ne"].shape == (1, 8, 32)
        t5 = load_t5_encoder(face_files["t5"], dev, dtype=torch.float32)
        for key, prompt in (("pe", "two people talking"), ("ne", "blurry")):
            assert np.array_equal(out[key], encode_prompts(t5, [prompt], face_files["t5"],
                                                           8).numpy())
        return
    name = flag[2:].split("_")[0]
    out = infer.encode_conditioning(args("--img_file_path", *FACE_IMGS, flag, face_files[name]),
                                    dev)
    white = lambda e: int((e["canvas"] == 255).all(-1).sum())
    norms = np.linalg.norm(out["id_cond"][0, :, :512], axis=-1)
    if name == "retinaface":
        assert not np.array_equal(out["canvas"], base["canvas"])
    elif name == "bisenet":
        assert white(out) > white(base)
        assert np.array_equal(out["id_cond"][..., :512], base["id_cond"][..., :512])
    else:
        assert np.allclose(np.linalg.norm(base["id_cond"][0, :, :512], axis=-1), 1, atol=1e-5)
        assert not np.allclose(norms, 1, atol=1e-2)
        assert np.array_equal(out["canvas"], base["canvas"])


@pytest.mark.parametrize("flags,item", [
    (["--tp", "2"], "A 12"), (["--sp", "2"], "A 12"),
    (["--reference_transformer", "x.safetensors"], "JAX package's importers"),
    (["--reference_audio_modules", "a.pt"], "JAX package's importers"),
    (["--reference_face_modules", "f.pt"], "JAX package's importers"),
    (["--reference_router_modules", "r.pt"], "JAX package's importers"),
    (["--lora_path", "l.safetensors"], "JAX package's importers"),
])
def test_cli_refuses_what_is_not_ported(flags, item, tmp_path):
    with pytest.raises(NotImplementedError, match=item):
        infer.main(TINY + ["--output_dir", str(tmp_path)] + flags)


def _recorded_generate(monkeypatch):
    """Record each `generate` call's pipeline, arguments and output."""
    calls, generate = [], BindYourAvatarPipeline.generate

    def recording(self, *a, **kw):
        out = generate(self, *a, **kw)
        calls.append((self, a, kw, out))
        return out

    monkeypatch.setattr(BindYourAvatarPipeline, "generate", recording)
    return calls


def test_two_stage_cli_forces_stage_2_with_the_tools_masks(tmp_path, capsys, monkeypatch):
    """`--two_stage_generate` without `--tracking_mask_dir` (no SAM2
    checkpoint: the tool's coarse masks) from two faces: the mask directory
    holds 9 frames per identity; stage 2 runs on stage 1's pipeline and
    equals, bit for bit, its own `generate` given the forcing read from
    those masks and a generator seeded with the same `--seed`."""
    monkeypatch.delenv("BYA_SAM2_CKPT", raising=False)
    calls = _recorded_generate(monkeypatch)
    out = tmp_path / "out"
    path = infer.main(TINY + ["--output_dir", str(out), "--audio_path"] + AUDIO +
                      ["--img_file_path"] + FACE_IMGS + ["--two_stage_generate", "--seed", "7"])
    meta = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    mask_dir = out / "tracking_mask_results"
    assert meta["mask_dir"] == str(mask_dir) and meta["mask_tool_seconds"] >= 0
    assert sorted(os.listdir(mask_dir)) == ["1", "2", "valid_frame.json"]
    assert all(len(os.listdir(mask_dir / i)) == 9 for i in ("1", "2"))
    assert os.path.getsize(path) > 0 and len(calls) == 2
    (pipe1, a1, kw1, stage1), (pipe2, a2, kw2, stage2) = calls
    assert pipe2 is pipe1 and "routing_forcing" not in kw1 and kw2["id_cond"] is not None
    forcing = tmasks.masks_to_routing_logits(str(mask_dir), *pipe1.dit.cfg.latent_grid)
    assert np.array_equal(kw2["routing_forcing"].numpy(), forcing)
    assert len(np.unique(forcing)) > 1
    pe, ne, image, _ = a2
    monkeypatch.undo()
    direct = pipe1.generate(pe, ne, image, torch.Generator().manual_seed(7),
                            **{**kw2, "routing_forcing": torch.from_numpy(forcing)})
    assert torch.equal(direct, stage2)
    assert not torch.equal(stage1, stage2)


def test_two_stage_cli_raises_when_the_mask_tool_fails(tmp_path, monkeypatch):
    """A mask tool that fails (here `$BYA_SAM2_CKPT` names a missing
    file) fails the run with its error, after stage 1's clip was written."""
    monkeypatch.setenv("BYA_SAM2_CKPT", str(tmp_path / "missing_sam2.pt"))
    out = tmp_path / "out"
    with pytest.raises(RuntimeError, match="mask tool failed .*FileNotFoundError"):
        infer.main(TINY + ["--output_dir", str(out), "--audio_path"] + AUDIO +
                   ["--two_stage_generate"])
    assert (out / "output.mp4").is_file()


def test_cli_runs_on_the_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    """Without `--device cpu` and with no CUDA device the CLI raises; and
    `main` raises when OpenCV is missing (the card's machine has none)
    rather than skip the export."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        infer.run(infer.get_args(["--model_size", "tiny"]))
    monkeypatch.setattr(infer, "run", lambda args: infer.InferRun(
        video=np.zeros((1, 2, 3, 8, 8), np.float32), routing=None, grid=(1, 1, 1), meta={}))
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError):
        infer.main(["--output_dir", str(tmp_path)])
    assert not (tmp_path / "output.mp4").exists()

"""The on-disk datasets, their helpers and the validation hook of the port
against the JAX package's, on the CPU.

Fixture trees written here with `cv2.VideoWriter` (as
`tests/test_reference_layout.py` writes its own): the index layout of
`AvatarVideoDataset` (two samples, one with a single identity's masks, and
a row whose annotation is missing, so the retry path runs) and the
reference's exact layout of `ReferenceLayoutDataset` (two clips, one whose
mask track is missing).  Samples equal JAX's bit for bit, every key, and
the error logs line for line.  The launcher trains on the index at tiny,
and `make_validation_fn` writes its mp4 from the frames JAX's writes (same
converted weights, initial latents and SDE noise; within 5e-4 of the
largest magnitude: the encode of the conditioning frame, 2 steps and the
decode, which amplifies the latents' 1e-5, as in `test_torch_slice.py`).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bindyouravatar_tpu.training import data as jdata
from bindyouravatar_tpu_torch.training import data
from torch_port_utils import max_err, realistic, threads_per_worker

FRAMES_TOTAL, H, W = 20, 64, 96


@pytest.fixture(autouse=True, scope="module")
def _threads():
    with threads_per_worker():
        yield


def _video(path: str, rng, n: int = FRAMES_TOTAL) -> None:
    import cv2

    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 25, (W, H))
    yy, xx = np.mgrid[0:H, 0:W]
    for f in range(n):
        img = np.stack([(xx * 2 + f * 5) % 256, (yy * 3 + f) % 256,
                        rng.integers(0, 255, (H, W))], -1).astype(np.uint8)
        wr.write(img)
    wr.release()


def _masks(d, xs, n: int = FRAMES_TOTAL, name="{:05d}.png") -> None:
    from PIL import Image

    d.mkdir(parents=True)
    for fr in range(n):
        m = np.zeros((H, W), np.uint8)
        m[:, xs] = 255
        m[fr % H, :] = 128                      # a row of non-binary luma
        Image.fromarray(m).save(str(d / name.format(fr)))


@pytest.fixture(scope="module")
def avatar_index(tmp_path_factory):
    """An index of `video_root,anno_json,anno_base` rows: sample 0 with two
    identities' masks, bboxes and audio tracks; sample 1 with one identity,
    the speaker on the right, no valid_frames; row 2's annotation missing."""
    tmp = tmp_path_factory.mktemp("avatar")
    rng = np.random.default_rng(0)
    videos = tmp / "videos"
    videos.mkdir()
    rows = []
    for j in range(2):
        _video(str(videos / f"clip{j}.mp4"), rng)
        base = tmp / f"anno{j}"
        _masks(base / "1", slice(0, W // 2))
        if j == 0:
            _masks(base / "2", slice(W // 2, W))
        audio = []
        for a in range(2 - j):
            p = str(base / f"audio{a}.pt")
            torch.save(torch.from_numpy(rng.standard_normal((FRAMES_TOTAL + 3, 2, 16))
                                        .astype(np.float32)), p)
            audio.append(p)
        anno = {"video": f"clip{j}.mp4", "caption": f"clip {j}", "audio_emb": audio,
                "bboxes": {"1": [3.5, 4, 40, 50]} if j else {"1": [3.5, 4, 40, 50],
                                                              "2": [50, 2, 94.2, 60]},
                "speaker_left": j == 0}
        if j == 0:
            anno["valid_frames"] = [3, 4, 5]
        (tmp / f"anno{j}.json").write_text(json.dumps(anno))
        rows.append(f"{videos},{tmp / f'anno{j}.json'},{base}")
    rows.append(f"{videos},{tmp / 'missing.json'},{tmp / 'anno9'}")
    index = tmp / "index.txt"
    index.write_text("\n".join(rows) + "\n")
    return str(index), tmp


@pytest.fixture(scope="module")
def reference_index(tmp_path_factory):
    """The reference's layout (`tests/test_reference_layout.py`'s tree):
    clip0 whole, clip1 with its second track's masks missing."""
    tmp = tmp_path_factory.mktemp("reference")
    rng = np.random.default_rng(1)
    videos, anno_base = tmp / "videos", tmp / "anno"
    videos.mkdir()
    items = []
    for j in range(2):
        base = f"clip{j}"
        _video(str(videos / f"{base}.mp4"), rng)
        td = anno_base / "track_masks_data" / base
        for track, xs in (("1", slice(0, W // 2)), ("4", slice(W // 2, W))):
            if j == 1 and track == "4":
                continue
            _masks(td / "tracking_mask_results" / track, xs, name="annotated_frame_{:05d}.png")
        (td / "valid_frame.json").write_text(json.dumps(
            {"1": {"face": list(range(2, FRAMES_TOTAL)), "head": [0, 1]},
             "2": {"face": list(range(FRAMES_TOTAL))}}))
        (td / "corresponding_data.json").write_text(json.dumps(
            {"1": {"face": 1}, "2": {"head": 4}}))
        bb = {str(fr): {"face": [{"new_track_id": 1, "box": {"x1": 2, "y1": 2, "x2": 40,
                                                            "y2": 60}}],
                        "head": [{"new_track_id": 2, "box": {"x1": 50.5, "y1": 2, "x2": 90,
                                                            "y2": 61}}]}
              for fr in range(FRAMES_TOTAL)}
        (anno_base / "refine_bbox_jsons").mkdir(parents=True, exist_ok=True)
        (anno_base / "refine_bbox_jsons" / f"{base}.json").write_text(json.dumps(bb))
        subs = ("left_audio", "right_audio") if j == 0 else ("",)
        for sub in subs:
            d = anno_base / "audio_emb" / sub
            d.mkdir(parents=True, exist_ok=True)
            torch.save(torch.from_numpy(rng.standard_normal((FRAMES_TOTAL + 4, 2, 16))
                                        .astype(np.float32)), str(d / f"{base}.pt"))
        items.append({"path": base, "cap": f"two people {j}", "fps": 25, "duration": 10,
                      "speaker": "left" if j == 0 else "right"})
    items.append({"path": "short", "cap": "", "fps": 25, "duration": 0.1})
    (tmp / "list.json").write_text(json.dumps(items))
    index = tmp / "index.txt"
    index.write_text(f"{videos},{tmp / 'list.json'},{anno_base}\n")
    return str(index), tmp


def _assert_samples_equal(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, np.ndarray):
            assert got[k].dtype == w.dtype and np.array_equal(got[k], w), k
        else:
            assert got[k] == w, k


def test_avatar_dataset_equals_jax(avatar_index, tmp_path):
    """Every sample of the index (the third through the retry) and the
    error log against JAX's, bit for bit."""
    index, _ = avatar_index
    kw = dict(num_frames=9, height=48, width=72)
    jds = jdata.AvatarVideoDataset(index, error_log=str(tmp_path / "jax.txt"), **kw)
    tds = data.AvatarVideoDataset(index, error_log=str(tmp_path / "port.txt"), **kw)
    assert len(tds) == len(jds) == 3
    for i in range(3):
        _assert_samples_equal(tds[i], jds[i])
    assert tds[1]["single_face"] and float(tds[1]["masks"][1].max()) == 0.0
    log = (tmp_path / "port.txt").read_text()
    assert log == (tmp_path / "jax.txt").read_text() and log.startswith("2\tFileNotFoundError")


def test_avatar_dataset_raises_after_its_retries(tmp_path):
    (tmp_path / "index.txt").write_text(f"{tmp_path},{tmp_path / 'none.json'},{tmp_path}\n")
    ds = data.AvatarVideoDataset(str(tmp_path / "index.txt"), max_retries=3,
                                 error_log=str(tmp_path / "err.txt"))
    with pytest.raises(data.DatasetError, match="exceeded retries"):
        ds[0]
    assert len((tmp_path / "err.txt").read_text().splitlines()) == 3


def test_reference_layout_dataset_equals_jax(reference_index, tmp_path):
    """Both clips (the short item filtered out; clip1's missing track fails,
    is logged and resampled) against JAX's, bit for bit, at two seeds."""
    index, _ = reference_index
    for seed in (0, 5):
        kw = dict(num_frames=9, height=48, width=72, seed=seed)
        jds = jdata.ReferenceLayoutDataset(index, error_log=str(tmp_path / f"j{seed}.txt"), **kw)
        tds = data.ReferenceLayoutDataset(index, error_log=str(tmp_path / f"p{seed}.txt"), **kw)
        assert len(tds) == len(jds) == 2
        for i in range(2):
            _assert_samples_equal(tds[i], jds[i])
        assert (tmp_path / f"p{seed}.txt").read_text() == (tmp_path / f"j{seed}.txt").read_text()
    assert "FileNotFoundError" in (tmp_path / "p0.txt").read_text()


def test_helpers_equal_jax(avatar_index):
    """`short_resize_and_pad` (uint8 RGB and float masks, landscape and
    portrait), `square_expand_crop` (inside, clipped, empty), the segment
    helpers and `load_audio_embedding` (the window's zero rows at both
    ends) against JAX's, bit for bit; the port's decoder is
    `utils/media.read_video_frames`, which decodes as JAX's."""
    _, tmp = avatar_index
    rng = np.random.default_rng(4)
    frames = rng.integers(0, 255, (3, 50, 70, 3), dtype=np.uint8)
    for shape in ((48, 72), (72, 48), (50, 70)):
        assert np.array_equal(data.short_resize_and_pad(frames, *shape),
                              jdata.short_resize_and_pad(frames, *shape))
    masks = (rng.uniform(size=(2, 50, 70, 1)) > 0.5).astype(np.float32) * 255.0
    assert np.array_equal(data.short_resize_and_pad(masks, 48, 72),
                          jdata.short_resize_and_pad(masks, 48, 72))
    for bb in ((3.5, 4, 40, 30), (-10, -5, 30, 20), (69, 49, 69, 49), (80, 60, 90, 70)):
        assert np.array_equal(data.square_expand_crop(frames[0], bb, out_size=32),
                              jdata.square_expand_crop(frames[0], bb, out_size=32))
    vf = {"face": [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 30, 31], "head": [2, 3, 12]}
    assert data.get_valid_segments(vf, 5) == jdata.get_valid_segments(vf, 5)
    for n, r in ((5, None), (5, 3), (30, 3)):
        rng_a = None if r is None else np.random.default_rng(r)
        rng_b = None if r is None else np.random.default_rng(r)
        assert (data.generate_frame_indices_for_face(n, vf, 5, 2, 2, rng_a)
                == jdata.generate_frame_indices_for_face(n, vf, 5, 2, 2, rng_b))
    pt = str(tmp / "anno0" / "audio0.pt")
    for start in (0, 3, 18):
        assert np.array_equal(data.load_audio_embedding(pt, start, 9),
                              jdata.load_audio_embedding(pt, start, 9))
    video = str(tmp / "videos" / "clip0.mp4")
    assert np.array_equal(data.read_video_frames(video, [5, 1, 5, 19]),
                          jdata.read_video_frames(video, [5, 1, 5, 19]))


def test_sft_launcher_trains_on_the_index(avatar_index, tmp_path):
    """`training.sft --index_file` at tiny: the launcher's dataset is the
    index's (the configuration's 9 x 128 x 192 clips), one step, finite
    metrics, the bad row's error in the run's own error log."""
    import math

    from bindyouravatar_tpu_torch.training import sft

    index, _ = avatar_index
    rows = open(index).read().splitlines()
    # one layout a batch: the two-track sample twice (a batch stacks its samples' tracks)
    (tmp_path / "index.txt").write_text("\n".join([rows[0], rows[0], rows[2]]) + "\n")
    index = str(tmp_path / "index.txt")
    out = str(tmp_path / "run")
    run = sft.main(["--model_size", "tiny", "--device", "cpu", "--index_file", index,
                    "--output_dir", out, "--max_train_steps", "2", "--checkpointing_steps", "2",
                    "--seed", "4"])
    assert run.state.step == 2
    with open(os.path.join(out, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows] == [1, 2]
    assert all(math.isfinite(v) for r in rows for v in r.values())
    assert os.path.isfile(os.path.join(out, "error_log.txt"))


def test_validation_fn_writes_jax_frames(tmp_path, monkeypatch):
    """`make_validation_fn` on the tiny DiT (converted weights) + tiny VAE:
    `validation-{step}/video_0.mp4` written, its frames those of JAX's
    `make_validation_fn` (2 steps, the same initial latents and SDE noise),
    the DiT back on the training path after the call; an EMA-like tensor
    swapped in for a call and the live one put back."""
    from bindyouravatar_tpu.config import PipelineConfig as JPipelineConfig
    from bindyouravatar_tpu.config import VAEConfig as JVAEConfig
    from bindyouravatar_tpu.models.dit import DiT as JDiT
    from bindyouravatar_tpu.models.vae import CausalVAE as JCausalVAE
    from bindyouravatar_tpu.pipeline.pipeline import BindYourAvatarPipeline as JPipeline
    from bindyouravatar_tpu.training.validation import make_validation_fn as jmake
    from bindyouravatar_tpu.utils import media as jmedia
    from bindyouravatar_tpu_torch.config import PipelineConfig
    from bindyouravatar_tpu_torch.convert import jax_params_to_torch
    from bindyouravatar_tpu_torch.models.dit import DiT
    from bindyouravatar_tpu_torch.models.vae import CausalVAE
    from bindyouravatar_tpu_torch.pipeline.pipeline import BindYourAvatarPipeline
    from bindyouravatar_tpu_torch.training.validation import make_validation_fn
    from bindyouravatar_tpu_torch.utils import media

    jd = JDiT.tiny()
    jv = JCausalVAE(JVAEConfig(block_out_channels=(8, 8, 16, 16), layers_per_block=1,
                               latent_channels=4, norm_num_groups=4, dtype=jnp.float32))
    dp = realistic(jax.eval_shape(jd.init, jax.random.key(0)), seed=1)
    vp = realistic(jax.eval_shape(jv.init, jax.random.key(1)), seed=2)
    td, tv = DiT.tiny(device="cpu"), CausalVAE.tiny(device="cpu")
    td.load_state_dict(jax_params_to_torch(dp), strict=True)
    tv.load_state_dict(jax_params_to_torch(vp), strict=True)
    c = jd.cfg
    kw = dict(height=c.sample_height * 8, width=c.sample_width * 8, num_frames=c.sample_frames)
    rng = np.random.default_rng(6)
    pe = rng.standard_normal((1, c.max_text_seq_length, c.text_embed_dim)).astype(np.float32)
    lat = rng.standard_normal((1, c.latent_frames, 4, c.sample_height,
                               c.sample_width)).astype(np.float32)
    frames = {}

    def capture(which, real):
        def export(video, path, fps=25):
            frames[which] = np.asarray(video)
            return real(video, path, fps)
        return export

    monkeypatch.setattr(jmedia, "export_to_video", capture("jax", jmedia.export_to_video))
    monkeypatch.setattr(media, "export_to_video", capture("port", media.export_to_video))
    jfn = jmake(JPipeline.create(jd, jv, JPipelineConfig(**kw)), vp, str(tmp_path / "jax"), pe,
                cond={"latents": jnp.asarray(lat)}, num_inference_steps=2, seed=3)
    jfn(4, dp)
    # the JAX loop's SDE noise from key(seed): (carry, init) split, then one a step
    k, noise = jax.random.split(jax.random.key(3))[0], []
    for _ in range(2):
        k, k_noise = jax.random.split(k)
        noise.append(torch.from_numpy(np.array(jax.random.normal(k_noise, lat.shape))))
    pipe = BindYourAvatarPipeline.create(td, tv, PipelineConfig(**kw))
    td.set_fuse_qk_norm(False)
    tfn = make_validation_fn(pipe, str(tmp_path / "port"), pe, num_inference_steps=2, seed=3,
                             cond={"latents": torch.from_numpy(lat), "noise": noise})
    tfn(4, dict(td.named_parameters()))
    assert os.path.getsize(tmp_path / "port" / "validation-4" / "video_0.mp4") > 0
    assert frames["port"].shape == frames["jax"].shape == (c.sample_frames, 3, kw["height"],
                                                           kw["width"])
    assert max_err(frames["port"], frames["jax"]) <= 5e-4 * float(np.abs(frames["jax"]).max())
    assert os.path.getsize(tmp_path / "jax" / "validation-4" / "video_0.mp4") > 0
    assert not td.cfg.fuse_qk_norm and not td.blocks[0].attn1.fuse_qk_norm
    # tensors that are not the DiT's own (an EMA copy) are used for the call only
    live = td.blocks[0].ff.net_0.bias
    before = live.detach().clone()
    tfn(5, {**dict(td.named_parameters()), "blocks.0.ff.net_0.bias": torch.zeros_like(live)})
    assert not np.array_equal(frames["port"], frames["jax"])
    assert torch.equal(live.detach(), before)

"""The port's face stack against the JAX package's, on the CPU.

The three networks whole (IR-100 at [2, 3, 112, 112], RetinaFace-R50 at
[1, 3, 96, 128], BiSeNet at [2, 3, 96, 128]) on the same weights (JAX's
importer of a reference-format state dict, then `convert.py` into the
port) and inputs, in fp32: every output within a relative L2 of 1e-5 of
JAX's.  Their readers equal JAX's importer followed by `convert.py` tensor
for tensor, bit for bit, on the state dicts of the JAX tests' torch mirrors
of the reference nets (`num_batches_tracked`, BiSeNet's auxiliary heads and
a `module.` prefix included).  The host-side copies (anchors, decode, NMS,
alignment, whiteout, resize, `HashEmbedder`, `draw_kps`) equal JAX's bit for
bit; the upsamples agree to 1e-6.  `FaceProcessor.process_split` on the
shipped faces `assets/faces/000_*.png` equals JAX's on converted EVA-CLIP
weights (the canvas and the hash half of `id_cond` bit for bit, the rest
to 1e-5), with the default backends and with all three checkpoints.  The
CLI's face flow (`--img_file_path` with the three checkpoint flags and
`--t5_dir`, tiny tier) hands the pipeline what JAX's `infer.py` builds from
the same files.

Weights are drawn at realistic scale: conv and linear weights ~ N(0,
1/fan_in), BN gains ~ N(1, 0.1), running variances ~ U(0.5, 1.5).  For the
detection flows RetinaFace's heads are set so that every stride-32 anchor
holds a face and no other does, with the 5 landmarks on the ArcFace
template inside each anchor: random heads detect nothing or thousands of
boxes, and the flows need one face an image.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bindyouravatar_tpu.models.eva_clip import EVACLIPVision
from bindyouravatar_tpu.preprocess import arcface as ja
from bindyouravatar_tpu.preprocess import bisenet as jb
from bindyouravatar_tpu.preprocess import face as jf
from bindyouravatar_tpu.preprocess import retinaface as jr
from bindyouravatar_tpu.utils import media as jmedia
from bindyouravatar_tpu_torch.convert import jax_face_net_to_torch, jax_params_to_torch
from bindyouravatar_tpu_torch.models.eva_clip import EVAVisionTower
from bindyouravatar_tpu_torch.preprocess import arcface as ta
from bindyouravatar_tpu_torch.preprocess import bisenet as tb
from bindyouravatar_tpu_torch.preprocess import face as tf
from bindyouravatar_tpu_torch.preprocess import retinaface as tr
from bindyouravatar_tpu_torch.utils import media as tmedia
from torch_port_utils import realistic, threads_per_worker

REL_L2 = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FACES = [os.path.join(ROOT, "assets", "faces", f"000_{i}.png") for i in (0, 1)]
NETS = {  # name: (port class, JAX module, JAX importer, input shape, scale, dropped prefixes)
    "arcface": (ta.IResNet100, ja.IResNet100(), ja.import_arcface_weights, (2, 3, 112, 112), 1.0,
                ()),
    "retinaface": (tr.RetinaFace, jr.RetinaFace(), jr.import_retinaface_weights, (1, 3, 96, 128),
                   20.0, ()),
    "bisenet": (tb.BiSeNet, jb.BiSeNet(), jb.import_bisenet_weights, (2, 3, 96, 128), 1.0,
                tb.AUX_HEADS),
}


@pytest.fixture(autouse=True, scope="module")
def _threads():
    with threads_per_worker():
        yield


def _rel_l2(got, want) -> float:
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _mirror(name: str, detect: bool = False):
    """The JAX tests' torch mirror of a reference net with weights drawn
    from the port's `draw_cnn_` (its auxiliary heads keep the mirror's
    init), and its reference-format state dict.  `detect` sets
    RetinaFace's heads as the module docstring says."""
    from test_arcface_import import TIResNet100
    from test_bisenet import TBiSeNet
    from test_retinaface import TRetinaFace

    mirror = {"arcface": TIResNet100, "retinaface": TRetinaFace, "bisenet": TBiSeNet}[name]()
    drawn = ta.build(NETS[name][0], "cpu", torch.Generator().manual_seed(len(name)))
    if detect:
        with torch.no_grad():
            # landmark deltas (in units of 0.1 anchor size) that put the 5
            # points on the template scaled to the anchor box
            t = ((jf.ARCFACE_DST / 112.0 - 0.5) / 0.1).reshape(-1)
            for i in range(3):
                for head in ("ClassHead", "BboxHead", "LandmarkHead"):
                    drawn.get_submodule(f"{head}.{i}.conv1x1").weight.zero_()
                cls = drawn.get_submodule(f"ClassHead.{i}.conv1x1").bias
                cls.copy_(torch.tensor([-4.0, 4.0] * 2 if i == 2 else [4.0, -4.0] * 2))
                drawn.get_submodule(f"BboxHead.{i}.conv1x1").bias.zero_()
                lm = drawn.get_submodule(f"LandmarkHead.{i}.conv1x1").bias
                lm.copy_(torch.from_numpy(np.tile(t, 2)))
    missing, unexpected = mirror.load_state_dict(drawn.state_dict(), strict=False)
    assert not unexpected and all(k.endswith("num_batches_tracked") or
                                  k.startswith(tb.AUX_HEADS) for k in missing)
    return mirror.eval(), {k: v.clone() for k, v in mirror.state_dict().items()}


def write_face_checkpoints(d) -> dict:
    """Reference-format checkpoint files of the three nets in the directory
    `d` (ArcFace's keys under a `module.` prefix, as a DataParallel save
    writes them), with RetinaFace's detection heads: {name: path}."""
    paths = {}
    for name in NETS:
        _, sd = _mirror(name, detect=name == "retinaface")
        if name == "arcface":
            sd = {f"module.{k}": v for k, v in sd.items()}
        paths[name] = os.path.join(str(d), f"{name}.pth")
        torch.save(sd, paths[name])
    return paths


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    return write_face_checkpoints(tmp_path_factory.mktemp("face_ckpts"))


def _jax_sd(sd):
    return {k: v.numpy() for k, v in sd.items() if "num_batches" not in k}


@pytest.mark.parametrize("name", sorted(NETS))
def test_face_net_matches_jax(name):
    cls, jmod, jimport, shape, scale, _ = NETS[name]
    _, sd = _mirror(name)
    params = jimport(_jax_sd(sd))
    x = scale * np.random.default_rng(1).standard_normal(shape, dtype=np.float32)
    want = jmod.apply({"params": params}, jnp.asarray(x))
    model = ta.build(cls, "cpu")
    model.load_state_dict(jax_face_net_to_torch(jax.tree.map(np.asarray, params), name))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel_l2(g, w) <= REL_L2


@pytest.mark.parametrize("name", sorted(NETS))
def test_face_net_reader_equals_jax_import_and_convert(name, ckpts):
    """The port's strict load of the reference file against JAX's importer
    of the same file + the converter, bit for bit."""
    cls, _, jimport, _, _, drop = NETS[name]
    sd = torch.load(ckpts[name], weights_only=True)
    want = jax_face_net_to_torch(jimport(_jax_sd(ta.reference_state_dict(sd))), name)
    got = ta.load_reference(cls, ckpts[name], "cpu", drop).state_dict()
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    # what the reader drops: the BN counters, the prefix and the aux heads only
    assert set(ta.reference_state_dict(sd, drop)) == set(got)
    assert len(sd) - len(got) == sum(k.endswith("num_batches_tracked") or
                                     k.startswith(tb.AUX_HEADS) for k in sd)


@pytest.mark.parametrize("mode,src,dst", [("nearest", (3, 5), (12, 20)),
                                          ("nearest", (7, 5), (13, 9)),
                                          ("bilinear", (5, 7), (13, 9)),
                                          ("bilinear", (24, 32), (96, 128))])
def test_upsamples_match_jax(mode, src, dst):
    x = np.random.default_rng(2).standard_normal((2, 3) + src, dtype=np.float32)
    fns = {"nearest": (tr.upsample_nearest, jb._upsample_nearest),
           "bilinear": (tb.upsample_bilinear_ac, jb._upsample_bilinear_ac)}[mode]
    got = fns[0](torch.from_numpy(x), dst).numpy()
    want = np.asarray(fns[1](jnp.asarray(x.transpose(0, 2, 3, 1)), dst)).transpose(0, 3, 1, 2)
    assert got.shape == want.shape and np.abs(got - want).max() <= 1e-6


def _host_case(case: str):
    """(port result, JAX result) of one host-side copy on the same inputs."""
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (200, 160, 3), dtype=np.uint8)
    lmk = jf.ARCFACE_DST * 1.3 + rng.normal(0, 2, (5, 2)).astype(np.float32) + 10
    if case == "prior_boxes":
        return tr.prior_boxes(96, 128), jr.prior_boxes(96, 128)
    if case == "decode":
        pri = jr.prior_boxes(64, 96)
        loc, lm = rng.normal(0, 0.5, (len(pri), 4)), rng.normal(0, 0.5, (len(pri), 10))
        return ((tr.decode_boxes(loc, pri), tr.decode_landmarks(lm, pri)),
                (jr.decode_boxes(loc, pri), jr.decode_landmarks(lm, pri)))
    if case == "nms":
        xy = rng.uniform(0, 100, (200, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(5, 40, (200, 2))], 1).astype(np.float32)
        scores = rng.uniform(0, 1, 200).astype(np.float32)
        return tr.nms(boxes, scores), jr.nms(boxes, scores)
    if case == "align":
        return ((tf.estimate_norm(lmk, 112), tf.warp_align(img, lmk, 112),
                 tf.warp_align(img, lmk, 512)),
                (jf.estimate_norm(lmk, 112), jf.warp_align(img, lmk, 112),
                 jf.warp_align(img, lmk, 512)))
    if case == "whiteout":
        labels = rng.integers(0, 19, img.shape[:2])
        return tuple((m.parse_whiteout(img, labels), m.parse_whiteout(img, labels,
                                                                     skip_bg_removal=True))
                     for m in (tf, jf))
    if case == "resize_long":
        big = rng.integers(0, 256, (1500, 900, 3), dtype=np.uint8)
        return tf.resize_numpy_image_long(big), jf.resize_numpy_image_long(big)
    if case == "hash_embedder":
        x = rng.uniform(-1, 1, (2, 3, 112, 112)).astype(np.float32)
        return ta.HashEmbedder()(x), ja.HashEmbedder()(x)
    assert case == "draw_kps"
    kps = [lmk, lmk[:, ::-1] + 30]
    return tmedia.draw_kps(240, 200, kps), jmedia.draw_kps(240, 200, kps)


@pytest.mark.parametrize("case", ["prior_boxes", "decode", "nms", "align", "whiteout",
                                  "resize_long", "hash_embedder", "draw_kps"])
def test_host_copies_equal_jax(case):
    got, want = _host_case(case)
    flat = lambda t: list(jax.tree_util.tree_leaves(t))
    assert len(flat(got)) == len(flat(want))
    for g, w in zip(flat(got), flat(want)):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.fixture(scope="module")
def eva():
    """The tiny EVA-CLIP: JAX's definition and weights, and the port's tower
    on their conversion."""
    jeva = EVACLIPVision.tiny()
    params = realistic(jax.eval_shape(jeva.init, jax.random.key(0)), seed=4)
    tower = EVAVisionTower.tiny("cpu")
    tower.load_state_dict(jax_params_to_torch(params))
    return jeva, jax.tree.map(jnp.asarray, params), tower


def _faces():
    import cv2

    return [cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2RGB) for p in FACES]


def _assert_split_equal(got, want, hash_half: bool):
    assert np.array_equal(got["canvas"], want["canvas"])
    assert got["id_cond"].shape == want["id_cond"].shape
    arc_g, arc_w = got["id_cond"][..., :512], np.asarray(want["id_cond"])[..., :512]
    if hash_half:
        assert np.array_equal(arc_g, arc_w)
    else:
        assert _rel_l2(arc_g, arc_w) <= REL_L2
    assert _rel_l2(got["id_cond"][..., 512:], np.asarray(want["id_cond"])[..., 512:]) <= REL_L2
    assert got["id_vit_hidden"].shape == np.asarray(want["id_vit_hidden"]).shape
    assert _rel_l2(got["id_vit_hidden"], want["id_vit_hidden"]) <= REL_L2


def test_process_split_on_the_shipped_faces_matches_jax(eva):
    """The default backends: full-frame detection, `HashEmbedder`, no parser."""
    jeva, params, tower = eva
    want = jf.build_default_processor(eva=jeva, eva_params=params).process_split(_faces())
    got = tf.build_default_processor(eva=tower, device="cpu").process_split(_faces())
    assert got["canvas"].shape == (480, 720, 3) and (got["canvas"] != 255).any()
    assert got["id_cond"].shape == (1, 2, 512 + 16)
    _assert_split_equal(got, want, hash_half=True)


def test_face_stack_from_checkpoints_matches_jax(eva, ckpts):
    """RetinaFace detection + alignment, the BiSeNet whiteout and the IR-100
    embedding, each from its reference file, on both sides."""
    jeva, params, tower = eva
    files = {f"{n}_checkpoint": ckpts[n] for n in NETS}
    jproc = jf.build_default_processor(eva=jeva, eva_params=params, **files)
    proc = tf.build_default_processor(eva=tower, device="cpu", **files)
    assert proc.detector.backend == "retinaface" and proc.face_parser is not None
    faces = proc.detector(_faces()[0])
    assert faces and faces[0].landmarks.shape == (5, 2)
    _assert_split_equal(proc.process_split(_faces()), jproc.process_split(_faces()),
                        hash_half=False)


@pytest.fixture(scope="module")
def t5_dir(tmp_path_factory):
    from test_torch_encoders import make_t5_dir

    pytest.importorskip("transformers")

    d = str(tmp_path_factory.mktemp("t5"))
    make_t5_dir(d)
    return d


def test_cli_face_flow_matches_jax(eva, ckpts, t5_dir, tmp_path, monkeypatch):
    """`python -m bindyouravatar_tpu_torch.infer --img_file_path (the shipped
    faces) --retinaface_checkpoint --bisenet_checkpoint --arcface_checkpoint
    --t5_dir --prompt --negative_prompt` at the tiny tier, end to end (an
    mp4), against the root `infer.py`'s flow on the same files: the tiny
    EVA-CLIP on converted weights on both sides, JAX's T5 at the directory's
    shapes in fp32 (its CLI assumes t5-xxl's).  JAX's pipeline is replaced by
    a recorder of what `generate` is handed (JAX's tiny DiT does not take
    the face stack's widths); the port's runs and records the same."""
    import functools
    import types

    import infer as jinfer

    from bindyouravatar_tpu.config import T5Config as JT5Config
    from bindyouravatar_tpu.config import tiny_dit_config as j_tiny_dit_config
    from bindyouravatar_tpu.models import t5 as jt5
    from bindyouravatar_tpu.training import import_encoders as jimp
    from bindyouravatar_tpu_torch import infer
    from bindyouravatar_tpu_torch.pipeline.pipeline import BindYourAvatarPipeline

    jeva, params, tower = eva
    audio = [os.path.join(ROOT, "assets", "audio_emb", f"000_{i}.pt") for i in (0, 1)]
    argv = ["--model_size", "tiny", "--num_frames", "9", "--height", "128", "--width", "192",
            "--num_inference_steps", "2", "--img_file_path", *FACES, "--t5_dir", t5_dir,
            "--prompt", "two people talking on a sofa", "--negative_prompt", "blurry",
            "--audio_path", *audio] + [a for n in NETS for a in (f"--{n}_checkpoint", ckpts[n])]

    class Recorded(Exception):
        pass

    seen = {}

    def j_generate(params_, pe, ne, image, key, image_bg=None, routing_forcing=None, **cond):
        seen["jax"] = dict(pe=pe, ne=ne, image=image, **cond)
        raise Recorded

    jcfg = JT5Config(vocab_size=128, d_model=32, d_kv=8, d_ff=64, num_layers=2, num_heads=4,
                     dtype=jnp.float32)
    monkeypatch.setattr(jinfer, "build_models", lambda args: types.SimpleNamespace(
        dit=types.SimpleNamespace(cfg=j_tiny_dit_config()), generate=j_generate))
    monkeypatch.setattr(jinfer, "load_params", lambda pipe, args: {})
    monkeypatch.setattr(jf, "build_default_processor", functools.partial(
        jf.build_default_processor, eva=jeva, eva_params=params))
    monkeypatch.setattr(jt5, "encode_prompts", functools.partial(jt5.encode_prompts, cfg=jcfg))
    monkeypatch.setattr(jimp, "import_t5_encoder", functools.partial(jimp.import_t5_encoder,
                                                                      cfg=jcfg))
    with pytest.raises(Recorded):
        jinfer.main(argv + ["--output_dir", str(tmp_path / "jax")])

    generate = BindYourAvatarPipeline.generate

    def t_generate(self, pe, ne, image, generator, **kw):
        seen["port"] = dict(pe=pe, ne=ne, image=image, **kw)
        return generate(self, pe, ne, image, generator, **kw)

    monkeypatch.setattr(infer, "tiny_eva", lambda device: tower)
    monkeypatch.setattr(BindYourAvatarPipeline, "generate", t_generate)
    out = infer.main(argv + ["--device", "cpu", "--output_dir", str(tmp_path / "port")])
    assert os.path.getsize(out) > 0

    got, want = seen["port"], seen["jax"]
    assert tuple(got["id_cond"].shape) == (1, 2, 512 + 16)
    assert tuple(got["id_vit_hidden"].shape) == (1, 2, 5, 5, 32)
    assert tuple(got["pe"].shape) == tuple(got["ne"].shape) == (1, 8, 32)
    assert np.array_equal(got["image"].numpy(), np.asarray(want["image"]))   # the canvas
    assert not bool((got["image"] == 1).all())
    assert np.array_equal(got["audio_embeds"].numpy(), np.asarray(want["audio_embeds"]))
    for k in ("id_cond", "id_vit_hidden", "pe", "ne"):
        assert _rel_l2(got[k], want[k]) <= REL_L2, k
    assert _rel_l2(got["pe"], want["ne"]) > 1e-2   # the negative prompt is its own

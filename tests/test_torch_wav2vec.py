"""The port's wav2vec2 extractor (`preprocess/wav2vec2.py`,
`preprocess/audio.extract_wav2vec_embeddings`) against the JAX package's,
which runs `transformers.Wav2Vec2Model`, on the CPU in fp32: a tiny model
(2 layers, 32 wide, the base layout's kernels and strides) written with
`save_pretrained` into the test's directory, read by the port in both file
formats and both weight-norm namings; the embeddings within 1e-5 absolute
of JAX's."""

import ast
import os
import pathlib

import numpy as np
import pytest
import torch

os.environ.setdefault("USE_TF", "0")   # transformers: torch only, no TensorFlow import
transformers = pytest.importorskip("transformers")

from bindyouravatar_tpu.preprocess.audio import \
    extract_wav2vec_embeddings as jax_extract  # noqa: E402
from bindyouravatar_tpu_torch.preprocess import audio, wav2vec2  # noqa: E402
from torch_port_utils import threads_per_worker  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _threads():
    with threads_per_worker():
        yield


def _tiny_config():
    return transformers.Wav2Vec2Config(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
        conv_dim=(16,) * 7, num_conv_pos_embeddings=8, num_conv_pos_embedding_groups=4)


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory):
    """{"safetensors", "bin", "weight_g", "ctc"}: the same drawn model as
    `model.safetensors` (weight norm as parametrizations), as
    `pytorch_model.bin`, as a bin with the `weight_g` / `weight_v` naming,
    and inside a ForCTC checkpoint (`wav2vec2.` prefix, `lm_head`)."""
    torch.manual_seed(0)
    model = transformers.Wav2Vec2Model(_tiny_config()).eval()
    with torch.no_grad():
        for p in model.parameters():       # away from the init's ones and zeros
            p.add_(0.05 * torch.randn_like(p))
    root = tmp_path_factory.mktemp("w2v")
    dirs = {"safetensors": root / "st", "bin": root / "bin", "weight_g": root / "wg",
            "ctc": root / "ctc"}
    model.save_pretrained(dirs["safetensors"])
    model.save_pretrained(dirs["bin"], safe_serialization=False)
    sd = model.state_dict()
    old = {k.replace("parametrizations.weight.original0", "weight_g")
            .replace("parametrizations.weight.original1", "weight_v"): v for k, v in sd.items()}
    assert any(k.endswith("weight_g") for k in old)
    for name, tensors in (("weight_g", old), ("ctc", {**{f"wav2vec2.{k}": v for k, v in sd.items()},
                                                        "lm_head.weight": torch.zeros(5, 32),
                                                        "lm_head.bias": torch.zeros(5)})):
        dirs[name].mkdir()
        (dirs[name] / "config.json").write_text((dirs["bin"] / "config.json").read_text())
        torch.save(tensors, dirs[name] / "pytorch_model.bin")
    return {k: str(v) for k, v in dirs.items()}


@pytest.fixture(scope="module")
def wav_path(tmp_path_factory):
    from scipy.io import wavfile

    rng = np.random.default_rng(1)
    t = np.arange(16000 * 2) / 16000
    sig = 0.4 * np.sin(2 * np.pi * 220 * t) + 0.1 * rng.standard_normal(t.shape)
    path = str(tmp_path_factory.mktemp("wav") / "a.wav")
    wavfile.write(path, 16000, (sig * 32767).astype(np.int16))
    return path


@pytest.mark.parametrize("fmt", ["safetensors", "bin", "weight_g", "ctc"])
def test_extract_matches_jax(model_dirs, wav_path, fmt):
    """[num_pixel_frames, layers, hidden] against JAX's on the same wav,
    `model_dir` and `$BYA_WAV2VEC_DIR` alike."""
    want = jax_extract(wav_path, 49, model_dir=model_dirs["safetensors"])
    got = audio.extract_wav2vec_embeddings(wav_path, 49, model_dir=model_dirs[fmt],
                                           device="cpu")
    assert got.shape == want.shape == (49, 2, 32) and got.dtype == np.float32
    assert float(np.abs(got - want).max()) < 1e-5


def test_env_dir_and_missing_checkpoint(model_dirs, wav_path, monkeypatch):
    monkeypatch.setenv("BYA_WAV2VEC_DIR", model_dirs["bin"])
    got = audio.extract_wav2vec_embeddings(wav_path, 13, device="cpu")
    assert got.shape == (13, 2, 32)
    monkeypatch.delenv("BYA_WAV2VEC_DIR")
    with pytest.raises(FileNotFoundError, match="BYA_WAV2VEC_DIR"):
        audio.extract_wav2vec_embeddings(wav_path, 13, device="cpu")


def test_hidden_states_match_transformers(model_dirs):
    """Every hidden state (the normalised input of layer 0 and each layer's
    output) against `output_hidden_states=True` on a batch of 2."""
    ref = transformers.Wav2Vec2Model.from_pretrained(model_dirs["safetensors"]).eval()
    port = wav2vec2.load_wav2vec2(model_dirs["weight_g"], device="cpu")
    wav = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 8000)).astype(np.float32))
    with torch.no_grad():
        want = ref(wav, output_hidden_states=True).hidden_states
        got = port(wav)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) < 1e-5


def test_reader_refuses_unknown_and_missing_keys(model_dirs, tmp_path):
    sd = torch.load(os.path.join(model_dirs["bin"], "pytorch_model.bin"), weights_only=True)
    for name, tensors in (("extra", {**sd, "encoder.extra.weight": torch.zeros(1)}),
                          ("missing", {k: v for k, v in sd.items()
                                       if k != "encoder.layer_norm.bias"})):
        d = tmp_path / name
        d.mkdir()
        (d / "config.json").write_text(open(os.path.join(model_dirs["bin"], "config.json")).read())
        torch.save(tensors, d / "pytorch_model.bin")
        with pytest.raises(ValueError, match=name.replace("extra", "unexpected")):
            wav2vec2.load_wav2vec2(str(d), device="cpu")


def test_port_modules_import_no_transformers():
    for rel in ("preprocess/wav2vec2.py", "preprocess/audio.py"):
        tree = ast.parse((ROOT / "bindyouravatar_tpu_torch" / rel).read_text())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
        assert not any(n.split(".")[0] == "transformers" for n in names), rel

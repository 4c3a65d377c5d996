"""The port's conditioning encoders against the JAX package's, on the CPU.

T5 (`models/t5.py`) and EVA-CLIP (`models/eva_clip.py`) on the same numpy-
drawn weights (`convert.jax_params_to_torch` of the flax tree) and inputs,
in fp32: each output within a relative L2 of 1e-5 of JAX's.  T5 at its tiny
config and at 2 layers of the T5-XXL widths (4096, 64 heads of 64, d_ff
10,240; the vocabulary cut to 512 rows) over 2 x 226 tokens with masked
keys; EVA-CLIP at its tiny config and at 2 blocks of the EVA02-CLIP-L
widths (1024, 16 heads, 577 tokens, both blocks tapped).  Kernels are drawn
~ N(0, 1/fan_in) (T5's q further by d_kv^-1/2, as T5's own init), norm
gains ~ N(1, 0.1), other leaves ~ N(0, 0.1): T5 scores carry no 1/sqrt(d),
so larger draws saturate every softmax and hide convention bugs.  The
readers (`t5_state_dict` / `load_t5_encoder`, `eva_state_dict`) equal
JAX's importers followed by `convert.py` tensor for tensor, bit for bit,
on the reference-format state dicts of transformers' `T5EncoderModel` and
of the JAX tests' EVA mirror; the EVA reader's q/k permutation is load-
bearing.  `encode_prompts` on a directory written here (a tiny
`T5EncoderModel.save_pretrained` and a word-level tokenizer) equals JAX's.
"""

import os

os.environ.setdefault("USE_TF", "0")   # transformers: torch only, no TensorFlow import

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bindyouravatar_tpu.config import EVACLIPConfig as JEVAConfig
from bindyouravatar_tpu.config import T5Config as JT5Config
from bindyouravatar_tpu.models import t5 as jt5
from bindyouravatar_tpu.models.eva_clip import EVACLIPVision
from bindyouravatar_tpu.models.eva_clip import _vision_rope_tables as j_rope_tables
from bindyouravatar_tpu.training.import_encoders import import_eva_vision, import_t5_encoder
from bindyouravatar_tpu_torch.config import EVACLIPConfig, T5Config
from bindyouravatar_tpu_torch.convert import jax_params_to_torch
from bindyouravatar_tpu_torch.models import t5 as tt5
from bindyouravatar_tpu_torch.models.eva_clip import (EVAVisionTower, _vision_rope_tables,
                                                      eva_state_dict)
from torch_port_utils import threads_per_worker

REL_L2 = 1e-5
T5_CASES = {
    "tiny": dict(vocab_size=128, d_model=32, d_kv=8, d_ff=64, num_layers=2, num_heads=4),
    "xxl_widths_2_layers": dict(vocab_size=512, num_layers=2),
}
EVA_CASES = {
    "tiny": dict(image_size=28, patch_size=14, width=32, depth=6, heads=4, out_dim=16,
                 hidden_taps=(1, 2, 3, 4, 5), pt_hw_seq_len=2),
    "l336_widths_2_blocks": dict(depth=2, hidden_taps=(0, 1)),
}


@pytest.fixture(autouse=True, scope="module")
def _threads():
    with threads_per_worker():
        yield


def _rel_l2(got, want) -> float:
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _draw(shapes, seed: int, q_scale: float = 1.0):
    """numpy weights for a flax tree of shapes (see the module docstring)."""
    rng = np.random.default_rng(seed)

    def draw(path, x):
        names = [str(getattr(p, "key", p)) for p in path]
        if names[-1] == "scale" or (names[-1] == "weight" and names[-2].startswith(("ln_",
                                                                                  "final_ln"))):
            a = 1.0 + 0.1 * rng.standard_normal(x.shape, dtype=np.float32)
        elif names[-1] == "kernel":
            a = rng.standard_normal(x.shape, dtype=np.float32)
            a *= np.float32(np.prod(x.shape[:-1]) ** -0.5 * (q_scale if names[-2] == "q" else 1))
        elif names[-1] in ("token_embedding", "relative_attention_bias"):
            a = rng.standard_normal(x.shape, dtype=np.float32)
        else:
            a = 0.1 * rng.standard_normal(x.shape, dtype=np.float32)
        return a

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.mark.parametrize("case", sorted(T5_CASES))
def test_t5_matches_jax(case):
    """T5 forward on 2 x 226 tokens, the second row's last 100 keys masked."""
    kw = T5_CASES[case]
    jenc = jt5.T5TextEncoder(JT5Config(dtype=jnp.float32, **kw))
    params = _draw(jax.eval_shape(jenc.init, jax.random.key(0)), seed=1,
                   q_scale=jenc.cfg.d_kv ** -0.5)
    rng = np.random.default_rng(2)
    ids = rng.integers(0, kw["vocab_size"], (2, 226))
    mask = np.ones((2, 226), bool)
    mask[1, 126:] = False
    want = np.asarray(jenc.apply(params, jnp.asarray(ids), jnp.asarray(mask)))
    model = tt5.T5Encoder.create(T5Config(dtype=torch.float32, **kw), device="cpu")
    model.load_state_dict(jax_params_to_torch(params))
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask))
    assert got.shape == want.shape == (2, 226, jenc.cfg.d_model)
    assert _rel_l2(got, want) <= REL_L2


@pytest.mark.parametrize("buckets,distance,s", [(32, 128, 226), (8, 16, 40), (32, 128, 7)])
def test_t5_position_buckets_equal_jax(buckets, distance, s):
    rel = np.arange(s)[None, :] - np.arange(s)[:, None]
    assert np.array_equal(tt5.relative_position_bucket(rel, buckets, distance),
                          jt5.relative_position_bucket(rel, buckets, distance))


def _hf_t5():
    from transformers import T5Config as HFT5Config
    from transformers import T5EncoderModel

    torch.manual_seed(0)
    return T5EncoderModel(HFT5Config(
        vocab_size=128, d_model=32, d_kv=8, d_ff=64, num_layers=2, num_heads=4,
        feed_forward_proj="gated-gelu", dropout_rate=0.0, is_encoder_decoder=False,
        use_cache=False)).eval()


TINY_HF = dict(vocab_size=128, d_model=32, d_kv=8, d_ff=64, num_layers=2, num_heads=4)


def _assert_same(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("fmt", ["state_dict", "safetensors", "bin"])
def test_t5_reader_equals_jax_import_and_convert(fmt, tmp_path):
    """`t5_state_dict` (a state dict) and `load_t5_encoder` (an HF dir with
    `model.safetensors` or `pytorch_model.bin`) against JAX's
    `import_t5_encoder` on the same state dict or file + the converter."""
    pytest.importorskip("transformers")
    model = _hf_t5()
    cfg = JT5Config(dtype=jnp.float32, **TINY_HF)
    if fmt == "state_dict":
        sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
        got = tt5.t5_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                                T5Config(**TINY_HF))
        want = jax_params_to_torch(import_t5_encoder(sd, cfg))
    else:
        model.save_pretrained(str(tmp_path), safe_serialization=fmt == "safetensors")
        path = tt5.t5_weights_file(str(tmp_path))
        assert path.endswith("model.safetensors" if fmt == "safetensors" else
                             "pytorch_model.bin")
        got = tt5.load_t5_encoder(str(tmp_path), "cpu", dtype=torch.float32).state_dict()
        want = jax_params_to_torch(import_t5_encoder(path, cfg))
    _assert_same(got, want)


def make_t5_dir(path: str) -> None:
    """A T5 directory: a tiny transformers `T5EncoderModel` saved with
    `save_pretrained` and a word-level fast tokenizer."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    words = ["<pad>", "</s>", "<unk>"] + "two people talking on a sofa blurry".split()
    tok = Tokenizer(models.WordLevel({w: i for i, w in enumerate(words)}, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    PreTrainedTokenizerFast(tokenizer_object=tok, pad_token="<pad>", unk_token="<unk>",
                            eos_token="</s>").save_pretrained(path)
    _hf_t5().save_pretrained(path)


def test_encode_prompts_on_a_t5_dir_matches_jax(tmp_path):
    """The `--t5_dir` path: tokenize at 8 tokens (padded, the second prompt
    empty: every key masked), encode, every row returned."""
    pytest.importorskip("transformers")
    make_t5_dir(str(tmp_path))
    prompts = ["two people talking on a sofa", ""]
    cfg = JT5Config(dtype=jnp.float32, **TINY_HF)
    params = import_t5_encoder(tt5.t5_weights_file(str(tmp_path)), cfg)
    want = np.asarray(jt5.encode_prompts(params, prompts, str(tmp_path), cfg, max_length=8))
    model = tt5.load_t5_encoder(str(tmp_path), "cpu", dtype=torch.float32)
    assert model.cfg == T5Config(dtype=torch.float32, **TINY_HF)
    got = tt5.encode_prompts(model, prompts, str(tmp_path), max_length=8)
    assert got.shape == want.shape == (2, 8, 32)
    assert _rel_l2(got, want) <= REL_L2


@pytest.mark.parametrize("case", sorted(EVA_CASES))
def test_eva_matches_jax(case):
    """The tower on 2 images: the pooled projection and every tap."""
    kw = EVA_CASES[case]
    jeva = EVACLIPVision(JEVAConfig(dtype=jnp.float32, **kw))
    c = jeva.cfg
    params = _draw(jax.eval_shape(jeva.init, jax.random.key(0)), seed=3)
    img = np.random.default_rng(4).standard_normal((2, 3, c.image_size, c.image_size),
                                                   dtype=np.float32)
    want_pool, want_hidden = (np.asarray(t) for t in jeva.apply(params, jnp.asarray(img)))
    tower = EVAVisionTower.create(EVACLIPConfig(dtype=torch.float32, **kw), device="cpu")
    tower.load_state_dict(jax_params_to_torch(params))
    with torch.no_grad():
        pool, hidden = tower(torch.from_numpy(img))
    assert hidden.shape == want_hidden.shape == (2, len(c.hidden_taps), c.seq_len, c.width)
    assert pool.shape == want_pool.shape == (2, c.out_dim)
    assert _rel_l2(pool, want_pool) <= REL_L2
    assert _rel_l2(hidden, want_hidden) <= REL_L2


def test_vision_rope_tables_equal_jax():
    got = _vision_rope_tables(24, 32, 16)
    want = j_rope_tables(24, 32, 16)
    assert all(np.array_equal(g, np.asarray(w)) for g, w in zip(got, want))


@pytest.fixture(scope="module")
def eva_mirror():
    """The JAX tests' EVA mirror at their config (a 4 x 4 RoPE grid on a
    pretrain grid of 2), drawn, and its reference-format state dict."""
    from test_eva_parity import TEVAVisionTower, _randomize, _reference_state_dict

    kw = dict(image_size=56, patch_size=14, width=32, depth=6, heads=4, out_dim=16,
              hidden_taps=(1, 3, 5), pt_hw_seq_len=2)
    tower = TEVAVisionTower(JEVAConfig(dtype=jnp.float32, **kw))
    _randomize(tower, 0)
    return tower, _reference_state_dict(tower), kw


def test_eva_reader_equals_jax_import_and_convert(eva_mirror):
    _, sd, kw = eva_mirror
    got = eva_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                         EVACLIPConfig(dtype=torch.float32, **kw))
    want = jax_params_to_torch(import_eva_vision(sd, JEVAConfig(dtype=jnp.float32, **kw)))
    _assert_same(got, want)
    # the `visual.` prefix of a whole CLIP checkpoint is read too
    pre = eva_state_dict({f"visual.{k}": torch.from_numpy(v) for k, v in sd.items()},
                         EVACLIPConfig(dtype=torch.float32, **kw))
    _assert_same(pre, want)


def test_eva_reader_qk_permutation_is_load_bearing(eva_mirror):
    """Through the reader the port's tower reproduces the reference mirror
    (EVA's interleaved RoPE); without the q/k permutation it does not."""
    import dataclasses

    mirror, sd, kw = eva_mirror
    cfg = EVACLIPConfig(dtype=torch.float32, **kw)
    tsd = {k: torch.from_numpy(v) for k, v in sd.items()}
    img = torch.from_numpy(np.random.default_rng(5).standard_normal((1, 3, 56, 56),
                                                                    dtype=np.float32))
    with torch.no_grad():
        want_pool, want_hidden = mirror(img)
        errs = []
        for perm_cfg in (cfg, dataclasses.replace(cfg, use_rope=False)):
            tower = EVAVisionTower.create(cfg, device="cpu")
            tower.load_state_dict(eva_state_dict(tsd, perm_cfg))
            pool, hidden = tower(img)
            errs.append((_rel_l2(pool, want_pool.numpy()), _rel_l2(hidden, want_hidden.numpy())))
    assert max(errs[0]) <= REL_L2 * 10        # the mirror: another implementation's sums
    assert errs[1][0] > 100 * max(errs[0][0], 1e-8)

"""The port's tensor-parallel DiT, TP server and partitioning rules against
the JAX package, on the CPU.

* The TP `DiT.apply` over 2 gloo ranks (`torch_dist_worker.py`, one spawn
  for the module, started first so it runs while JAX computes) against
  JAX's TP apply at its own tolerance (`tests/test_tp.py`: atol 5e-4, rtol
  1e-3) and against the port's one-rank apply (relative L2 1e-5).
* The TP server (rank 0 owns the queue, rank 1 follows) at `batch_max=2`
  against the one-rank server, also after a batch that fails on every
  rank; the CLI under `--tp 2` against one rank's.
* The TP plan and the FSDP rule against JAX's `tp_specs` and
  `_spec_for_leaf`, through the converter's names and transposes, with the
  port's exceptions listed; `shard_bytes` equal to JAX's exactly, at tiny
  and at the 5B widths (meta tensors against `jax.eval_shape`).
"""

import re

import jax
import numpy as np
import pytest
import torch

from bindyouravatar_tpu.models.dit import DiT as JDiT
from bindyouravatar_tpu.parallel.mesh import create_mesh as jax_mesh
from bindyouravatar_tpu.parallel.sharding import _spec_for_leaf
from bindyouravatar_tpu.parallel.sharding import shard_bytes as jax_shard_bytes
from bindyouravatar_tpu.parallel.tp import shard_params_tp as jax_shard_tp
from bindyouravatar_tpu.parallel.tp import tp_specs as jax_tp_specs
from bindyouravatar_tpu_torch.config import DiTConfig
from bindyouravatar_tpu_torch.convert import jax_params_to_torch
from bindyouravatar_tpu_torch.models.dit import DiT
from bindyouravatar_tpu_torch.parallel.sharding import param_specs, shard_bytes, shard_dim
from bindyouravatar_tpu_torch.parallel.tp import tp_specs
from torch_dist_worker import (Ranks, check_two_stage, check_two_stage_failure, cli_argv,
                               one_rank_cli, serve, serve_spec, two_stage_inputs)
from torch_port_utils import realistic, threads_per_worker

STEPS = 2


@pytest.fixture(autouse=True, scope="module")
def _threads():
    with threads_per_worker():
        yield


def _tp_inputs():
    jd = JDiT.tiny()
    c, a = jd.cfg, jd.audio_cfg
    params = jax.tree.map(np.asarray, realistic(jax.eval_shape(jd.init, jax.random.key(0)),
                                                seed=4))
    rng = np.random.default_rng(9)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    n_px = (c.latent_frames - 1) * 4 + 1
    arrays = dict(lat=f(1, c.latent_frames, c.in_channels, c.sample_height, c.sample_width),
                  text=f(1, c.max_text_seq_length, c.text_embed_dim),
                  ts=np.array([300.0], np.float32),
                  id_cond=f(1, c.num_ids, jd.lfe_cfg.id_embed_dim),
                  id_vit_hidden=f(1, c.num_ids, jd.lfe_cfg.num_scales, 9, jd.lfe_cfg.vit_dim),
                  audio_embeds=f(1, 2, n_px + a.window_size - a.window_stride, a.blocks,
                                 a.audio_dim))
    return jd, params, arrays

COND = ("id_cond", "id_vit_hidden", "audio_embeds")


def _port_dit(params, **kw):
    td = DiT.tiny(device="cpu", **kw)
    td.load_state_dict(jax_params_to_torch(params), strict=True)
    return td.eval()


@pytest.fixture(scope="module", autouse=True)
def started(tmp_path_factory):
    jd, params, arrays = _tp_inputs()
    c = jd.cfg
    td = DiT.tiny(device="cpu")
    rope = td.rope(c.sample_height * 8, c.sample_width * 8, c.latent_frames)
    t = {k: torch.from_numpy(v) for k, v in arrays.items()}
    inputs = dict(dit_kwargs={}, state=jax_params_to_torch(params),
                  args=(t["lat"], t["text"], t["ts"], rope),
                  kwargs={k: t[k] for k in COND}, server=serve_spec(),
                  cli_argv=cli_argv(str(tmp_path_factory.mktemp("cli"))),
                  **two_stage_inputs(tmp_path_factory.mktemp))
    ranks = Ranks("tp", 2, str(tmp_path_factory.mktemp("tp")), inputs)
    yield ranks
    ranks.close()


@pytest.fixture(scope="module")
def references():
    """JAX's TP apply on a 2-device tp mesh, and the port's one-rank apply."""
    jd, params, arrays = _tp_inputs()
    c = jd.cfg
    rope = jd.rope(c.sample_height * 8, c.sample_width * 8, c.latent_frames)
    mesh = jax_mesh(dp=1, fsdp=1, tp=2, devices=jax.devices()[:2])
    with mesh:
        sharded = jax_shard_tp(params, mesh)
        jout, _ = jax.jit(lambda p: jd.apply(p, arrays["lat"], arrays["text"], arrays["ts"], rope,
                                             **{k: arrays[k] for k in COND}))(sharded)
    td = _port_dit(params)
    t = {k: torch.from_numpy(v) for k, v in arrays.items()}
    with torch.no_grad():
        one, _ = td.apply(t["lat"], t["text"], t["ts"],
                          td.rope(c.sample_height * 8, c.sample_width * 8, c.latent_frames),
                          **{k: t[k] for k in COND})
    return np.asarray(jout), one.numpy()


@pytest.fixture(scope="module")
def ranks(started, references):
    return started.results()


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("rank", [0, 1])
def test_tp_dit_matches_jax_tp_apply(ranks, references, rank):
    """Face + audio; both ranks hold the whole output; the blocks' and the
    audio layers' heads split 6 -> 3 per rank."""
    r = ranks[rank]
    assert r["heads"] == (3, 3)
    np.testing.assert_allclose(r["tp_out"].numpy(), references[0], atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("rank", [0, 1])
def test_tp_dit_matches_one_rank(ranks, references, rank):
    assert _rel_l2(ranks[rank]["tp_out"].numpy(), references[1]) < 1e-5


@pytest.fixture(scope="module")
def one_rank_server():
    """The same two requests through a one-rank server."""
    return serve(serve_spec())


def test_tp_server_cobatches(ranks, one_rank_server):
    lead = ranks[0]
    assert lead["batch_sizes"] == [2.0, 2.0]
    assert ranks[1]["served"] == 4              # the pair, before and after the failure
    assert one_rank_server["batch_sizes"] == [2.0, 2.0]


def test_tp_server_survives_a_failed_batch(ranks, one_rank_server):
    """A request that raises inside `generate` on every rank fails its
    future; the follower stays in step, so the pair that follows completes
    and equals the one-rank server's (relative L2 1e-5)."""
    assert "RuntimeError" in ranks[0]["failure"], ranks[0]["failure"]
    assert "RuntimeError" in one_rank_server["failure"]
    for got, want in zip(ranks[0]["after_failure"], one_rank_server["after_failure"]):
        assert got.shape == want.shape and np.isfinite(got).all()
        assert _rel_l2(got, want) < 1e-5


@pytest.mark.parametrize("i", [0, 1])
def test_tp_server_video_equals_one_rank(ranks, one_rank_server, i):
    """Within relative L2 1e-5, the one-rank apply's bound: the row-parallel
    all-reduce sums in another order than one matmul does."""
    got, want = ranks[0]["videos"][i], one_rank_server["videos"][i]
    assert got.shape == want.shape and np.isfinite(got).all()
    assert _rel_l2(got, want) < 1e-5


def test_tp_cli_equals_one_rank(ranks, tmp_path):
    """`infer.run` under `--tp 2` (each rank's clip) against the one-rank
    CLI on the same flags."""
    want = one_rank_cli(str(tmp_path))
    for r in ranks:
        assert r["cli"].shape == want.shape and _rel_l2(r["cli"], want) < 1e-5


def test_tp_server_seeds_give_distinct_videos(ranks):
    a, b = ranks[0]["videos"]
    assert np.abs(a - b).max() > 1e-2


# --------------------------------------------------------------- the rules
def _jax_dims_in_port_names(params, specs, axis):
    """JAX's spec tree -> port name -> the port dim JAX's split lands on
    (None: replicated): each split leaf carries an index ramp along its
    split dim through the converter, and the port dim it varies along is
    the split's."""
    def ramp(leaf, spec):
        dims = [i for i, a in enumerate(spec) if a == axis]
        if not dims:
            return np.zeros(leaf.shape, np.float32)
        d = dims[0]
        shape = [1] * leaf.ndim
        shape[d] = leaf.shape[d]
        return np.broadcast_to(np.arange(leaf.shape[d], dtype=np.float32).reshape(shape) + 1,
                               leaf.shape).copy()

    tree = jax.tree.map(ramp, params, specs,
                        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    out = {}
    for name, t in jax_params_to_torch(tree).items():
        varying = [i for i in range(t.ndim)
                   if t.shape[i] > 1 and not torch.equal(t, t.narrow(i, 0, 1).expand_as(t))]
        assert len(varying) <= 1, name
        out[name] = varying[0] if varying else (None if not t.any() else "whole")
    return out


# the modules JAX's suffix rules split that the port keeps whole (see
# `parallel/tp.py`), and the LoRA B tensors and the audio layers' q/k/v
# biases, which the port splits where JAX does not
TP_REPLICATED_HERE = [r"^perceivers\.\d+\.", r"^router_", r"^lfe\."]
TP_SPLIT_HERE = [r"^blocks\.\d+\.attn1\.to_[qk]_lora_B$",
                 r"^audio_layers\.\d+\.to_[qkv]\.bias$"]


def test_tp_plan_matches_jax_tp_specs():
    """The port's TP plan (names, dims) against JAX's `tp_specs` at tp 2,
    mapped through the converter; every difference is one of the listed
    exceptions, and each exception occurs."""
    jd = JDiT.tiny(lora_rank=4)
    params = jax.eval_shape(jd.init, jax.random.key(0))
    want = _jax_dims_in_port_names(params, jax_tp_specs(params, 2), "tp")
    got = tp_specs(DiT.tiny(device="meta", lora_rank=4), 2)
    assert set(got) == set(want)
    diff = {k for k in got if got[k] != want[k]}
    only_jax = {k for k in diff if got[k] is None}
    only_port = {k for k in diff if want[k] is None}
    assert diff == only_jax | only_port           # never a different dim
    assert all(any(re.match(p, k) for p in TP_REPLICATED_HERE) for k in only_jax), only_jax
    assert all(any(re.match(p, k) for p in TP_SPLIT_HERE) for k in only_port), only_port
    assert {p for p in TP_REPLICATED_HERE + TP_SPLIT_HERE
            if not any(re.match(p, k) for k in diff)} == set()
    sharded = {k for k, d in got.items() if d is not None}
    assert "blocks.0.attn1.to_q.weight" in sharded and got["blocks.0.attn1.to_out.weight"] == 1
    assert got["blocks.0.attn1.norm_q.weight"] is None
    assert all(d is None for d in tp_specs(DiT.tiny(device="meta"), 1).values())


def test_tp_plan_keeps_whole_heads():
    """A block whose heads do not divide the tp size stays replicated."""
    got = tp_specs(DiT.tiny(device="meta"), 4)       # 6 heads
    assert got["blocks.0.attn1.to_q.weight"] is None
    assert got["blocks.0.ff.net_0.weight"] == 0


@pytest.mark.parametrize("fsdp", [2, 4])
def test_fsdp_rule_matches_jax_spec_for_leaf(fsdp):
    """`param_specs` against JAX's `_spec_for_leaf` through the converter:
    the same tensors sharded, on the same dims, no exceptions."""
    jd = JDiT.tiny(lora_rank=4)
    params = jax.eval_shape(jd.init, jax.random.key(0))
    specs = jax.tree_util.tree_map_with_path(lambda p, l: _spec_for_leaf(p, l, fsdp), params)
    want = _jax_dims_in_port_names(params, specs, "fsdp")
    got = param_specs(DiT.tiny(device="meta", lora_rank=4), fsdp)
    assert got == want
    # the threshold is judged on JAX's stacked [L, ...] size: some tensor
    # is sharded although one layer's is under 2^16 elements
    td = dict(DiT.tiny(device="meta", lora_rank=4).named_parameters())
    assert any(d is not None and td[k].numel() < 2 ** 16 for k, d in got.items())


def test_fsdp_rule_pins_the_sharded_dim():
    """JAX breaks ties toward the later dim, a flax kernel's output
    features: the port's dim 0 of [out, in]; a conv kernel's output
    channels likewise; a raw [in, out] tensor (LoRA A) keeps JAX's dim."""
    assert shard_dim("blocks.0.attn1.to_q.weight", (64, 64), 2, layers=16) == 0
    assert shard_dim("x.weight", (64, 128), 2, layers=8) == 1          # the larger dim
    assert shard_dim("x.weight", (32, 16, 4, 4), 2, layers=64) == 0
    assert shard_dim("blocks.0.attn1.to_q_lora_A", (256, 256), 2) == 1
    assert shard_dim("x.weight", (3, 5), 2, layers=2 ** 14) is None     # nothing divides


@pytest.mark.parametrize("fsdp", [2, 4])
def test_shard_bytes_equal_jax_tiny(fsdp):
    jd = JDiT.tiny()
    params = jax.eval_shape(jd.init, jax.random.key(0))
    mesh = jax_mesh(dp=8 // fsdp, fsdp=fsdp)
    assert shard_bytes(DiT.tiny(device="meta"), fsdp) == jax_shard_bytes(params, mesh)


def test_shard_bytes_equal_jax_5b():
    """At the 5B widths (42 layers, face + audio, LoRA r128) on meta
    tensors against `jax.eval_shape`: nothing is allocated."""
    from bindyouravatar_tpu.config import DiTConfig as JDiTConfig

    jd = JDiT.create(JDiTConfig(lora_rank=128))
    params = jax.eval_shape(jd.init, jax.random.key(0))
    td = DiT.create(DiTConfig(lora_rank=128), device="meta")
    for fsdp in (2, 4, 8):
        want = jax_shard_bytes(params, jax_mesh(dp=8 // fsdp, fsdp=fsdp))
        assert shard_bytes(td, fsdp) == want, fsdp


@pytest.mark.parametrize("flags,error", [
    (["--tp", "2", "--sp", "2"], SystemExit),
    (["--tp", "2", "--two_stage_generate"], ValueError),
])
def test_cli_refuses_tp_with_sp_and_the_ranked_mask_tool(flags, error, tmp_path):
    """--tp with --sp raises as JAX's CLI does, before any rank is asked;
    the two-stage CLI under --tp is taken (its mask tool runs on rank 0)
    and, in this one process, asks for the ranks the launch lacks."""
    from bindyouravatar_tpu_torch import infer

    with pytest.raises(error):
        infer.main(cli_argv(str(tmp_path)) + flags)


def test_tp_two_stage_cli_equals_one_rank(ranks, tmp_path):
    """`infer.main(... --two_stage_generate --tp 2)`: rank 0 runs the mask
    tool once, both ranks run stage 2, each clip equals one rank's."""
    check_two_stage(ranks, tmp_path)


def test_tp_two_stage_tool_failure_raises_on_every_rank(ranks):
    check_two_stage_failure(ranks)

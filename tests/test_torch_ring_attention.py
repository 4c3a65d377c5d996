"""Ring attention and the sequence-parallel DiT of the port against the
JAX package, on the CPU.

The port's ring (`ops/ring_attention.py`) runs each block through kernel
B7's forward (its plain version here) and merges the blocks by their LSEs;
JAX's runs plain einsums under `shard_map`.  Both are held to JAX's own
tolerances (`tests/test_ring_attention.py`): atol 2e-5 for the attention,
atol 2e-4 / rtol 1e-3 for `DiT.apply`.  The 2-rank cases run in two gloo
processes (`torch_dist_worker.py`, one spawn for the module); the in-process
loop (`ring_attention_local`, what `chip_smoke.py` runs on the card) covers
2 and 4 shards.  The CLI under `--sp 2` and a server whose pipeline runs
the ring over 2 ranks are held against one rank's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from bindyouravatar_tpu.models.dit import DiT as JDiT
from bindyouravatar_tpu.ops.ring_attention import ring_attention as jax_ring
from bindyouravatar_tpu_torch.convert import jax_params_to_torch
from bindyouravatar_tpu_torch.ops.ring_attention import block_kv_len, ring_attention_local
from torch_dist_worker import (Ranks, check_two_stage, check_two_stage_failure, cli_argv,
                               one_rank_cli, serve, serve_spec, two_stage_inputs)
from torch_port_utils import realistic, threads_per_worker

B, H, D = 2, 4, 32
# name -> (sequence length, valid_len): the whole sequence; a ragged tail;
# a tail that leaves the last shard (of 2 and of 4) all padding
CASES = {"full": (256, None), "valid": (256, 200), "padded_shard": (256, 100)}


@pytest.fixture(autouse=True, scope="module")
def _threads():
    with threads_per_worker():
        yield


def _qkv(s, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, s, H * D)).astype(np.float32) for _ in range(3)]


def _jax(qkv, n, valid_len):
    """JAX's ring over an n-device mesh, flat [B, S, H*D] out."""
    bhsd = lambda a: jnp.asarray(a.reshape(B, -1, H, D).transpose(0, 2, 1, 3))
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("sp",))
    o = jax_ring(*(bhsd(a) for a in qkv), mesh, valid_len=valid_len)
    return np.asarray(o).transpose(0, 2, 1, 3).reshape(B, -1, H * D)


def _sp_inputs():
    """The JAX test's sequence-parallel DiT inputs at twice the tiny frame
    count (face + audio), numpy."""
    jd = JDiT.tiny(in_channels=8, out_channels=4)
    c, a = jd.cfg, jd.audio_cfg
    params = jax.tree.map(np.asarray, realistic(jax.eval_shape(jd.init, jax.random.key(0)),
                                                seed=3))
    t2 = 2 * c.latent_frames
    n_px = (t2 - 1) * 4 + 1
    rng = np.random.default_rng(7)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    arrays = dict(
        lat=f(1, t2, c.in_channels, c.sample_height, c.sample_width),
        text=f(1, c.max_text_seq_length, c.text_embed_dim), ts=np.array([300.0], np.float32),
        id_cond=f(1, c.num_ids, jd.lfe_cfg.id_embed_dim),
        id_vit_hidden=f(1, c.num_ids, jd.lfe_cfg.num_scales, 9, jd.lfe_cfg.vit_dim),
        audio_embeds=f(1, 2, n_px + a.window_size - a.window_stride, a.blocks, a.audio_dim))
    return jd, params, arrays, t2, n_px


@pytest.fixture(scope="module", autouse=True)
def started(tmp_path_factory):
    """The 2 ranks (ring cases and the sp DiT step), one spawn, started
    first so that they run while the JAX references compute."""
    from bindyouravatar_tpu_torch.models.dit import DiT

    jd, params, arrays, t2, n_px = _sp_inputs()
    c = jd.cfg
    td = DiT.tiny(device="cpu", in_channels=8, out_channels=4)
    rope = td.rope(c.sample_height * 8, c.sample_width * 8, t2)
    t = {k: torch.from_numpy(v) for k, v in arrays.items()}
    inputs = dict(
        ring={name: dict(qkv=[torch.from_numpy(a) for a in _qkv(s, i)], heads=H, valid_len=vl)
              for i, (name, (s, vl)) in enumerate(CASES.items())},
        dit_kwargs=dict(in_channels=8, out_channels=4), state=jax_params_to_torch(params),
        args=(t["lat"], t["text"], t["ts"], rope),
        kwargs=dict(id_cond=t["id_cond"], id_vit_hidden=t["id_vit_hidden"],
                    audio_embeds=t["audio_embeds"], num_pixel_frames=n_px),
        cli_argv=cli_argv(str(tmp_path_factory.mktemp("cli"))), server=serve_spec(),
        **two_stage_inputs(tmp_path_factory.mktemp))
    ranks = Ranks("ring", 2, str(tmp_path_factory.mktemp("ring")), inputs)
    yield ranks
    ranks.close()


@pytest.fixture(scope="module")
def ranks(started, jax_sp):
    return started.results()


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_in_process_ring_matches_jax_ring(case, n):
    """Every (rank, step) pair of an n-shard ring in one process (B7's plain
    forward per block, the LSE merge) against JAX's ring on n devices."""
    s, valid_len = CASES[case]
    qkv = _qkv(s, list(CASES).index(case))
    got = ring_attention_local(*(torch.from_numpy(a) for a in qkv), H, n, valid_len=valid_len)
    want = _jax(qkv, n, valid_len)
    rows = slice(None) if valid_len is None else slice(0, valid_len)
    np.testing.assert_allclose(got.numpy()[:, rows], want[:, rows], atol=2e-5)


@pytest.mark.parametrize("case", list(CASES))
def test_two_rank_ring_matches_jax_ring(ranks, case):
    """`ring_attention` over 2 gloo ranks (K/V exchanged by
    batch_isend_irecv) against JAX's ring on a 2-device mesh."""
    s, valid_len = CASES[case]
    got = torch.cat([r[case] for r in ranks], dim=1).numpy()
    want = _jax(_qkv(s, list(CASES).index(case)), 2, valid_len)
    rows = slice(None) if valid_len is None else slice(0, valid_len)
    np.testing.assert_allclose(got[:, rows], want[:, rows], atol=2e-5)


def test_padded_shard_blocks_are_skipped():
    """A kv block wholly past valid_len gets kv_len 0 and is skipped (the
    kernel takes 0 < kv_len); the cases above have one at 2 and at 4."""
    assert [block_kv_len(src, 128, 100) for src in range(2)] == [100, 0]
    assert [block_kv_len(src, 64, 100) for src in range(4)] == [64, 36, 0, 0]
    assert [block_kv_len(src, 64, None) for src in range(4)] == [64] * 4


@pytest.fixture(scope="module")
def jax_sp():
    """JAX's `dit.apply(sp_mesh=...)` on a 2-device mesh: (output, routing)."""
    jd, params, arrays, t2, n_px = _sp_inputs()
    c = jd.cfg
    rope = jd.rope(c.sample_height * 8, c.sample_width * 8, t2)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("sp",))
    fn = jax.jit(functools.partial(jd.apply, sp_mesh=mesh, num_pixel_frames=n_px))
    out = fn(params, arrays["lat"], arrays["text"], arrays["ts"], rope,
             id_cond=arrays["id_cond"], id_vit_hidden=arrays["id_vit_hidden"],
             audio_embeds=arrays["audio_embeds"])
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("what", ["output", "routing"])
def test_two_rank_sp_dit_matches_jax_sp_apply(ranks, jax_sp, what):
    """`DiT.apply(sp_group=...)` at 2 ranks, twice the tiny frame count,
    against JAX's `dit.apply(sp_mesh=...)` on a 2-device mesh, converted
    weights; both ranks hold the whole output."""
    want = jax_sp[0 if what == "output" else 1]
    key = "sp_out" if what == "output" else "sp_routing"
    for r in ranks:
        np.testing.assert_allclose(r[key].float().numpy(), want, atol=2e-4, rtol=1e-3)


def test_sp_cli_equals_one_rank(ranks, tmp_path):
    """`infer.run` under `--sp 2` (each rank's clip) against the one-rank
    CLI on the same flags, within relative L2 1e-5."""
    want = one_rank_cli(str(tmp_path))
    for r in ranks:
        got = r["cli"]
        assert got.shape == want.shape
        assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-5


def test_sp_server_equals_one_rank(ranks):
    """Two co-batched requests through a server whose pipeline runs the ring
    over 2 ranks (rank 0 owns the queue, rank 1 follows) against the
    one-rank server, within relative L2 1e-5; then a request that raises
    inside `generate` on both ranks, and the pair again, which must still
    complete."""
    want = serve(serve_spec())
    assert ranks[0]["batch_sizes"] == want["batch_sizes"] == [2.0, 2.0]
    assert ranks[1]["served"] == 4              # the pair, before and after the failure
    assert "RuntimeError" in ranks[0]["failure"], ranks[0]["failure"]
    for got, ref in zip(ranks[0]["videos"] + ranks[0]["after_failure"],
                        want["videos"] + want["after_failure"]):
        assert got.shape == ref.shape
        assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 1e-5


def test_sp_two_stage_cli_equals_one_rank(ranks, tmp_path):
    """`infer.main(... --two_stage_generate --sp 2)`: rank 0 runs the mask
    tool once, both ranks run stage 2's ring, each clip equals one rank's."""
    check_two_stage(ranks, tmp_path)


def test_sp_two_stage_tool_failure_raises_on_every_rank(ranks):
    check_two_stage_failure(ranks)

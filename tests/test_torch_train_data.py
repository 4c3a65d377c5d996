"""The port's host-side training data (`utils/masks.py`, `training/data.py`)
against the JAX package's, on the CPU.

Everything here is numpy on both sides, so the comparisons are exact: the
same arrays bit for bit from the same seed.  The resize is held to JAX's
numpy formula and to its native library where that loads, on the index
masks too, at the synthetic left/right split whose downsampled edges land
exactly on 0.5 (the `> 0.5` of the index mask is decided on those ties).
"""

import time

import numpy as np
import pytest

from bindyouravatar_tpu.training import data as jdata
from bindyouravatar_tpu.utils import masks as jmasks
from bindyouravatar_tpu_torch.training import data as tdata
from bindyouravatar_tpu_torch.utils import masks as tmasks


def _split_masks(t, h, w, split=None):
    """The synthetic dataset's two identities: left and right of `split`."""
    split = w // 2 if split is None else split
    m = np.zeros((2, t, h, w), np.float32)
    m[0, :, :, :split] = 1.0
    m[1, :, :, split:] = 1.0
    return m


def _native_resize(mask, ot, oh, ow):
    """JAX's native library called directly, or None where it does not load."""
    lib = jmasks._load_native()
    if lib is None:
        return None
    src = np.ascontiguousarray(mask, np.float32)
    out = np.empty((ot, oh, ow), np.float32)
    lib.bya_resize_trilinear(src, *src.shape, out, ot, oh, ow)
    return out


@pytest.mark.parametrize("src,dst,ties", [
    ((49, 480, 720), (13, 30, 45), True),     # the 5B clip -> its latent grid
    ((17, 100, 150), (5, 13, 19), True),      # ragged
    ((9, 128, 192), (3, 8, 12), False),       # the tiny DiT's grid
])
def test_index_masks_equal_jax_numpy_and_native(src, dst, ties):
    masks = _split_masks(*src)
    for m in masks:
        got = tmasks.resize_mask_trilinear(m, *dst)
        np.testing.assert_array_equal(got, jmasks._numpy_trilinear(m, *dst))
        native = _native_resize(m, *dst)
        if native is not None:
            np.testing.assert_array_equal(got > 0.5, native > 0.5)
        assert bool((got == 0.5).any()) == ties
    got = tmasks.masks_to_index_mask(masks[0], masks[1], *dst)
    np.testing.assert_array_equal(got, jmasks.masks_to_index_mask(masks[0], masks[1], *dst))
    assert set(np.unique(got)) <= {-1, 0, 1} and (got == 0).any() and (got == 1).any()


def test_index_mask_on_random_masks_and_overlaps():
    """Random binary masks (values off the grid) and overlapping identities
    (id 2 wins); the routing one-hot."""
    rng = np.random.default_rng(3)
    m1 = (rng.random((9, 40, 60)) > 0.5).astype(np.float32)
    m2 = (rng.random((9, 40, 60)) > 0.4).astype(np.float32)
    np.testing.assert_array_equal(tmasks.resize_mask_trilinear(m1, 3, 7, 11),
                                  jmasks._numpy_trilinear(m1, 3, 7, 11))
    idx = tmasks.masks_to_index_mask(m1, m2, 3, 7, 11)
    np.testing.assert_array_equal(idx, jmasks.masks_to_index_mask(m1, m2, 3, 7, 11))
    both = (tmasks.resize_mask_trilinear(m1, 3, 7, 11).reshape(-1) > 0.5) & (
        tmasks.resize_mask_trilinear(m2, 3, 7, 11).reshape(-1) > 0.5)
    assert both.any() and (idx[both] == 1).all()
    np.testing.assert_array_equal(tmasks.index_mask_to_routing(idx, 2),
                                  jmasks.index_mask_to_routing(idx, 2))


@pytest.mark.parametrize("drop_prob", [0.0, 1.0])
def test_noisy_teacher_routing_equals_jax(drop_prob):
    """The same draws in the same order: equal outputs, and both generators
    left in the same state."""
    masks = _split_masks(17, 100, 150)
    idx = tmasks.masks_to_index_mask(masks[0], masks[1], 5, 13, 19)
    rt, rj = np.random.default_rng(7), np.random.default_rng(7)
    got = tmasks.noisy_teacher_routing(idx, (5, 13, 19), rt, 2, drop_prob=drop_prob)
    want = jmasks.noisy_teacher_routing(idx, (5, 13, 19), rj, 2, drop_prob=drop_prob)
    np.testing.assert_array_equal(got, want)
    assert rt.bit_generator.state == rj.bit_generator.state
    assert got.shape == (5 * 13 * 19, 2) and got.min() >= 0.0 and got.max() <= 1.0
    assert (got == 0).all() if drop_prob == 1.0 else 0.0 < got.mean() < 1.0


def test_synthetic_dataset_and_collate_equal_jax():
    kw = dict(length=5, num_frames=5, height=24, width=40, audio_blocks=2, audio_dim=8, seed=3)
    tds, jds = tdata.SyntheticAvatarDataset(**kw), jdata.SyntheticAvatarDataset(**kw)
    assert len(tds) == len(jds) == 5
    samples = []
    for i in (0, 4):
        got, want = tds[i], jds[i]
        assert set(got) == set(want)
        for k, v in want.items():
            if isinstance(v, np.ndarray):
                assert got[k].dtype == v.dtype
                np.testing.assert_array_equal(got[k], v)
            else:
                assert got[k] == v
        samples.append((got, want))
    got = tdata.collate([s[0] for s in samples])
    want = jdata.collate([s[1] for s in samples])
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(got[k], v)
        else:
            assert got[k] == v
    assert got["audio"].shape == (2, 2, 5 + tdata.AUDIO_WINDOW_SLACK, 2, 8)
    assert tdata.AUDIO_WINDOW_SLACK == jdata.AUDIO_WINDOW_SLACK


def test_helpers_equal_jax():
    for left in (True, False):
        np.testing.assert_array_equal(tdata.af_matrix_from_speaker(left, 2),
                                      jdata.af_matrix_from_speaker(left, 2))
    for ratio in (0.0, 0.5, 1.0):
        got = [tdata.maybe_drop_text("a", ratio, np.random.default_rng(s)) for s in range(8)]
        want = [jdata.maybe_drop_text("a", ratio, np.random.default_rng(s)) for s in range(8)]
        assert got == want


@pytest.mark.parametrize("shuffle", [True, False])
def test_resumable_sampler_equals_jax(shuffle):
    """The same index stream over three epochs, and the same state to
    resume from at any point."""
    ts, js = tdata.ResumableSampler(7, shuffle, seed=2), jdata.ResumableSampler(7, shuffle, seed=2)
    it_t, it_j = iter(ts), iter(js)
    for _ in range(17):
        assert next(it_t) == next(it_j)
        assert ts.state_dict() == js.state_dict()
    resumed = tdata.ResumableSampler(7, shuffle, seed=0)
    resumed.load_state_dict(ts.state_dict())
    it_r = iter(resumed)
    assert [next(it_r) for _ in range(6)] == [next(it_t) for _ in range(6)]


def _wait_full(loader, timeout=10.0):
    t0 = time.monotonic()
    while not loader.q.full() and time.monotonic() - t0 < timeout:
        time.sleep(0.01)
    assert loader.q.full()


def test_prefetch_loader_state_is_that_of_the_last_consumed_batch():
    """The port's loader hands each batch over with the sampler state after
    it, so a checkpoint taken after k batches resumes at batch k + 1.  JAX's
    `PrefetchLoader` leaves only the shared sampler, whose cursor its
    worker has moved up to prefetch + 1 batches ahead; the JAX driver saves
    that and a resumed JAX run skips those samples.  This test pins the
    port's deviation."""
    kw = dict(length=11, num_frames=1, height=8, width=8, audio_blocks=1, audio_dim=2)
    ds = tdata.SyntheticAvatarDataset(**kw)
    loader = tdata.PrefetchLoader(ds, tdata.ResumableSampler(len(ds), seed=1), 2)
    jloader = jdata.PrefetchLoader(jdata.SyntheticAvatarDataset(**kw),
                                   jdata.ResumableSampler(len(ds), seed=1), 2)
    try:
        assert loader.state_dict() == {"epoch": 0, "cursor": 0, "seed": 1}
        first = [next(loader) for _ in range(3)]
        jfirst = [next(jloader) for _ in range(3)]
        for b, jb in zip(first, jfirst):
            np.testing.assert_array_equal(b["video"], jb["video"])
        _wait_full(loader)
        _wait_full(jloader)
        state = loader.state_dict()
        assert state == {"epoch": 0, "cursor": 6, "seed": 1}
        ahead = lambda s: (s["epoch"], s["cursor"]) > (0, 6)
        assert ahead(loader.sampler.state_dict())                   # the worker's
        assert ahead(jloader.sampler.state_dict())                  # what JAX's driver saves
        following = [next(loader) for _ in range(4)]                # crosses an epoch
    finally:
        loader.close()
        jloader.close()
    sampler = tdata.ResumableSampler(len(ds), seed=0)
    sampler.load_state_dict(state)
    resumed = tdata.PrefetchLoader(ds, sampler, 2)
    try:
        for want in following:
            np.testing.assert_array_equal(next(resumed)["video"], want["video"])
    finally:
        resumed.close()

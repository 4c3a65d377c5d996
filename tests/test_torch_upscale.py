"""The port's RRDBNet and tiled upscaler against the JAX package's, on the
CPU.

`RRDBNet` at 2 RRDBs (8 features, grow 4) against JAX's on the weights of
a Real-ESRGAN-keyed state dict (JAX's `import_rrdbnet`, then
`convert.jax_rrdbnet_to_torch`), in fp32: relative L2 within `REL_L2`; the
port's strict reader `load_rrdbnet` on that state dict (plain, and under
`params_ema` in a file) equals the converter's tensors bit for bit, and a
missing or unknown key raises.  `tiled_scale` and `upscale` against JAX's on
a pointwise x4 model (exact against the untiled result too) and on
RRDBNet, with `batch_tiles` and an image smaller than the tile.  The
`_feather_mask` pin: equal to JAX's up to `feather = n`; past it the port
clamps to `n` where JAX raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bindyouravatar_tpu.models import rrdbnet as jrr
from bindyouravatar_tpu.utils import upscale as jup
from bindyouravatar_tpu_torch.convert import jax_rrdbnet_to_torch
from bindyouravatar_tpu_torch.models import rrdbnet as trr
from bindyouravatar_tpu_torch.utils import upscale as tup
from torch_port_utils import threads_per_worker

REL_L2 = 1e-5
NB, FEAT, GROW = 2, 8, 4


@pytest.fixture(autouse=True, scope="module")
def _threads():
    with threads_per_worker():
        yield


def _rel_l2(got, want) -> float:
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def esrgan_state_dict(nb=NB, feat=FEAT, grow=GROW, seed=0):
    """A Real-ESRGAN-keyed state dict (`tests/test_upscale.py`'s mirror)."""
    g = torch.Generator().manual_seed(seed)
    sd = {}

    def add(name, cin, cout):
        sd[name + ".weight"] = 0.2 * torch.randn(cout, cin, 3, 3, generator=g)
        sd[name + ".bias"] = 0.1 * torch.randn(cout, generator=g)

    add("conv_first", 3, feat)
    for i in range(nb):
        for m in (1, 2, 3):
            for k in range(1, 6):
                add(f"body.{i}.rdb{m}.conv{k}", feat + (k - 1) * grow, grow if k < 5 else feat)
    for name in ("conv_body", "conv_up1", "conv_up2", "conv_hr"):
        add(name, feat, feat)
    add("conv_last", feat, 3)
    return sd


@pytest.fixture(scope="module")
def nets():
    sd = esrgan_state_dict()
    params = jrr.import_rrdbnet(sd, num_block=NB)
    model = trr.build_rrdbnet(NB, "cpu", feat=FEAT, grow=GROW)
    model.load_state_dict(jax_rrdbnet_to_torch(params), strict=True)
    jmodel = jrr.RRDBNet(feat=FEAT, num_block=NB, grow=GROW)
    jfn = jax.jit(lambda x: jmodel.apply(params, x))
    return sd, params, model, jfn


def test_rrdbnet_matches_jax(nets):
    _, _, model, jfn = nets
    x = np.random.default_rng(1).standard_normal((2, 3, 12, 14)).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    want = jfn(jnp.asarray(x))
    assert tuple(got.shape) == tuple(want.shape) == (2, 3, 48, 56)
    assert _rel_l2(got, want) <= REL_L2


def test_reader_is_strict_and_equals_the_converter(nets, tmp_path):
    sd, params, _, _ = nets
    want = jax_rrdbnet_to_torch(params)
    path = tmp_path / "RealESRGAN_x4plus_test.pth"
    torch.save({"params_ema": sd}, path)
    for source in (sd, str(path)):
        got = trr.load_rrdbnet(source, NB, "cpu", feat=FEAT, grow=GROW).state_dict()
        assert sorted(got) == sorted(want)
        assert all(torch.equal(got[k], want[k]) for k in want)
    with pytest.raises(RuntimeError, match="Unexpected"):
        trr.load_rrdbnet({**sd, "conv_extra.weight": torch.zeros(1)}, NB, "cpu", feat=FEAT,
                         grow=GROW)
    with pytest.raises(RuntimeError, match="Missing"):
        trr.load_rrdbnet({k: v for k, v in sd.items() if k != "conv_hr.bias"}, NB, "cpu",
                         feat=FEAT, grow=GROW)


def _nearest4x_torch(t):
    return t.repeat_interleave(4, dim=-2).repeat_interleave(4, dim=-1)


def _nearest4x_jax(t):
    return jnp.repeat(jnp.repeat(t, 4, axis=-2), 4, axis=-1)


@pytest.mark.parametrize("case", [
    dict(shape=(2, 3, 40, 56), tile_x=16, tile_y=16, overlap=4, batch_tiles=0),
    dict(shape=(1, 3, 24, 100), tile_x=32, tile_y=64, overlap=8, batch_tiles=2),
])
def test_tiled_scale_pointwise_matches_jax_and_the_untiled_result(case):
    case = dict(case)
    x = np.random.default_rng(2).standard_normal(case.pop("shape")).astype(np.float32)
    got = tup.tiled_scale(torch.from_numpy(x), _nearest4x_torch, upscale_amount=4,
                          out_channels=3, **case)
    want = jup.tiled_scale(jnp.asarray(x), _nearest4x_jax, upscale_amount=4, out_channels=3,
                           **case)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), _nearest4x_torch(torch.from_numpy(x)).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_upscale_on_rrdbnet_matches_jax(nets):
    _, _, model, jfn = nets
    frames = np.random.default_rng(3).standard_normal((2, 3, 20, 28)).astype(np.float32)
    with torch.no_grad():
        got = tup.upscale(model, torch.from_numpy(frames), scale=4, tile=16, overlap=4,
                          batch_tiles=3)
        got_b = tup.upscale_batch_and_concatenate(model, torch.from_numpy(frames)[None],
                                                  scale=4, tile=16, overlap=4)
    want = jup.upscale(jfn, jnp.asarray(frames), scale=4, tile=16, overlap=4)
    assert tuple(got.shape) == (2, 3, 80, 112) and tuple(got_b.shape) == (1, 2, 3, 80, 112)
    assert _rel_l2(got, want) <= REL_L2
    np.testing.assert_allclose(got_b[0].numpy(), got.numpy(), rtol=1e-6, atol=1e-6)
    assert tup.get_tiled_scale_steps(720, 480, 512, 512, 32) == jup.get_tiled_scale_steps(
        720, 480, 512, 512, 32) == 2
    for size, tile, overlap in ((100, 32, 8), (20, 32, 4), (720, 512, 32)):
        assert np.array_equal(tup._origins(size, tile, overlap), jup._origins(size, tile, overlap))


def _ramp(n: int, f: int) -> np.ndarray:
    """The reference's in-place loop along one axis: `narrow(t) *= (t + 1)
    / f` from each end."""
    r = np.ones(n)
    for t in range(f):
        r[t] *= (t + 1) / f
        r[n - 1 - t] *= (t + 1) / f
    return r


@pytest.mark.parametrize("n,feather", [(6, 3), (6, 6), (6, 7), (8, 20)])
def test_feather_mask_pin(n, feather):
    """Up to feather = n the port's mask is JAX's; past it the port clamps
    the feather to each axis's length where JAX raises (ROADMAP.md
    deliberate deviations)."""
    shape = (n, n + 2)
    got = tup._feather_mask(shape, feather).numpy()
    want = np.outer(_ramp(n, min(feather, n)), _ramp(n + 2, min(feather, n + 2)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    if feather <= n:
        np.testing.assert_allclose(got, np.asarray(jup._feather_mask(shape, feather)),
                                   rtol=1e-6, atol=0)
    else:
        with pytest.raises(ValueError):
            jup._feather_mask(shape, feather)
    # a frame smaller than the overlap upscales whole
    x = torch.rand(1, 3, *shape)
    out = tup.tiled_scale(x, _nearest4x_torch, tile_x=32, tile_y=32, overlap=feather,
                          upscale_amount=4)
    np.testing.assert_allclose(out.numpy(), _nearest4x_torch(x).numpy(), rtol=1e-6)

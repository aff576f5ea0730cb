"""Plain PyTorch dense matcher and pyramid helpers vs the JAX reference.

Exact equality where the reference pins its twins bit-equal or the
computation is selections, integers or fixed-order adds: census transform,
census cost, popcount, right-view disparity, LR check, occlusion fill,
pyramid helpers and the median. The rest agree to f32 rounding (rtol 1e-5:
cumulative sums run in another order), and the dense backend end to end by
the reference's "close" rule."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stepth_tpu.config import MatchConfig as RefMatchConfig
from stepth_tpu.match import dense as ref_dense
from stepth_tpu.match import pyramid as ref_pyramid
from stepth_tpu_torch.config import MatchConfig
from stepth_tpu_torch.match import dense, pyramid

from tests.test_match_dense import make_pair
from tests.torch_port import assert_close, np_, one_torch_thread  # noqa: F401 (autouse fixture)


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_grayscale(rng, dtype):
    rgb = rng.uniform(0, 255, (17, 33, 3)).astype(dtype)
    np.testing.assert_allclose(
        np_(dense.grayscale(_t(rgb))), np_(ref_dense.grayscale(rgb)), rtol=1e-5
    )
    gray = rgb[..., 0]
    np.testing.assert_array_equal(
        np_(dense.grayscale(gray, device="cpu")), np_(ref_dense.grayscale(gray))
    )


def test_array_input_needs_device(rng):
    """An array without ``device=`` goes to the card; with no card it raises
    instead of running on the CPU, which only ``device="cpu"`` asks for."""
    x = rng.uniform(0, 1, (4, 4))
    if torch.cuda.is_available():
        assert dense.grayscale(x).device.type == "cuda"
    else:
        with pytest.raises(ValueError, match="no CUDA device"):
            dense.grayscale(x)
    assert dense.grayscale(x, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("cost", ["sad", "ssd"])
def test_cost_volume(rng, cost):
    left, right = make_pair(rng, h=24, w=40, shift=3)
    lg, rg = left.astype(np.float32), right.astype(np.float32)
    cfg = dict(num_disparities=8, cost=cost)
    want = ref_dense.cost_volume(jnp.asarray(lg), jnp.asarray(rg), RefMatchConfig(**cfg))
    got = dense.cost_volume(_t(lg), _t(rg), MatchConfig(**cfg))
    np.testing.assert_allclose(np_(got), np_(want), rtol=1e-5)


@pytest.mark.parametrize("census_window", [5, 7])
def test_cost_volume_census_exact(rng, census_window):
    """Census Hamming cost: integers, so exactly the reference's."""
    left, right = make_pair(rng, h=24, w=40, shift=3)
    lg, rg = left.astype(np.float32), right.astype(np.float32)
    cfg = dict(num_disparities=8, cost="census", census_window=census_window)
    want = ref_dense.cost_volume(jnp.asarray(lg), jnp.asarray(rg), RefMatchConfig(**cfg))
    got = dense.cost_volume(_t(lg), _t(rg), MatchConfig(**cfg))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(np_(got), np_(want))


@pytest.mark.parametrize("window", [3, 5, 7, 9])
def test_census_transform_bit_equal(rng, window):
    """The int32 planes carry the reference's uint32 bits (P = 1, 1, 2, 3),
    including plateaus where ``gray > neighbour`` ties."""
    g = rng.uniform(0, 255, (23, 41)).astype(np.float32)
    g[3:9, 4:12] = 100.0
    want = np.asarray(ref_dense.census_transform(jnp.asarray(g), window))
    got = dense.census_transform(_t(g), window)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(np_(got).view(np.uint32), want)
    lc, rc = dense.census_pair(_t(g), _t(g[::-1]), window)
    np.testing.assert_array_equal(np_(lc), np_(dense.census_planes(_t(g), window)))
    np.testing.assert_array_equal(np_(rc), np_(dense.census_planes(_t(g[::-1]), window)))


def test_popcount32(rng):
    x = rng.integers(-(2**31), 2**31, (1000,), dtype=np.int64).astype(np.int32)
    x[:4] = [0, -1, -(2**31), 2**31 - 1]
    want = [bin(int(v) & 0xFFFFFFFF).count("1") for v in x]
    np.testing.assert_array_equal(np_(dense.popcount32(_t(x))), want)


def test_right_disparity_from_volume_exact(rng):
    agg = rng.integers(0, 6, (10, 20, 8)).astype(np.float32)  # many ties
    want = ref_dense.right_disparity_from_volume(jnp.asarray(agg))
    np.testing.assert_array_equal(np_(dense.right_disparity_from_volume(_t(agg))), np_(want))


@pytest.mark.parametrize("num_disparities", [16, 130, None])
def test_lr_consistency_exact(rng, num_disparities):
    """The closed form equals the reference's sweep: shifts past D, the
    edge column (``xr = 0``), negative disparities and −1e6 right views."""
    dl = rng.uniform(-2, 20, (32, 130)).astype(np.float32)
    dl[:, :5] = 0.5
    dl[2, 3] = 2.5  # round half to even
    dr = rng.uniform(0, 20, (32, 130)).astype(np.float32)
    dr[4] = -1e6
    want = np.asarray(ref_dense.lr_consistency(jnp.asarray(dl), jnp.asarray(dr), 1.0,
                                               num_disparities))
    got = dense.lr_consistency(_t(dl), _t(dr), 1.0, num_disparities)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(np_(got), want)
    assert 0 < want.mean() < 1


def test_fill_invalid_exact(rng):
    disp = rng.uniform(0, 60, (48, 200)).astype(np.float32)
    valid = rng.uniform(size=(48, 200)) > 0.4
    valid[5] = False  # an all-invalid row
    valid[7] = True
    valid[:, :3] = False  # invalid left border
    valid[9, -4:] = False  # invalid right border
    want = np.asarray(ref_dense.fill_invalid(disp, valid))
    np.testing.assert_array_equal(np_(dense.fill_invalid(_t(disp), _t(valid))), want)


@pytest.mark.parametrize("lr_threshold", [None, 1.0])
@pytest.mark.parametrize("cost", ["sad", "census"])
def test_match_pair_matches_reference(rng, cost, lr_threshold):
    """The dense backend end to end: the "close" rule on the disparities
    (box sums are cumulative sums in another order), equal masks for
    census, whose costs are integers."""
    left, right = make_pair(rng, h=32, w=64, shift=4)
    cfg = dict(num_disparities=16, cost=cost, lr_threshold=lr_threshold, uniqueness=0.1)
    want = ref_dense.match_pair(left, right, RefMatchConfig(**cfg))
    got = dense.match_pair(left, right, MatchConfig(**cfg), device="cpu")
    assert_close(np_(want.disparity), np_(want.valid), np_(got.disparity), np_(got.valid))
    np.testing.assert_allclose(np_(got.cost), np_(want.cost), rtol=1e-5, atol=1e-3)
    if cost == "census":
        np.testing.assert_array_equal(np_(got.valid), np_(want.valid))
        np.testing.assert_array_equal(np_(got.disparity), np_(want.disparity))


@pytest.mark.parametrize("window", [1, 5, 9])
def test_box_aggregate(rng, window):
    vol = rng.uniform(0, 50, (21, 37, 4)).astype(np.float32)
    want = ref_dense.box_aggregate(jnp.asarray(vol), window)
    got = dense.box_aggregate(_t(vol), window)
    np.testing.assert_allclose(np_(got), np_(want), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("uniqueness", [None, 0.15])
@pytest.mark.parametrize("subpixel", [True, False])
def test_wta(rng, uniqueness, subpixel):
    left, right = make_pair(rng, h=24, w=48, shift=4)
    lg, rg = left.astype(np.float32), right.astype(np.float32)
    vol = ref_dense.box_aggregate(
        ref_dense.cost_volume(jnp.asarray(lg), jnp.asarray(rg), RefMatchConfig(num_disparities=12)),
        9,
    )
    vol = np.asarray(vol)
    want = ref_dense.wta(jnp.asarray(vol), subpixel, uniqueness)
    got = dense.wta(_t(vol), subpixel, uniqueness)
    np.testing.assert_allclose(np_(got[0]), np_(want[0]), rtol=1e-5)
    np.testing.assert_array_equal(np_(got[1]), np_(want[1]))
    np.testing.assert_allclose(np_(got[2]), np_(want[2]), rtol=1e-5)
    if uniqueness is not None:
        assert 0 < np_(got[1]).mean() < 1  # the test has teeth


@pytest.mark.parametrize("shape", [(23, 41), (8, 8), (1, 5)])
def test_median3_bit_equal(rng, shape):
    x = rng.uniform(0, 30, shape).astype(np.float32)
    np.testing.assert_array_equal(np_(dense.median3(_t(x))), np_(ref_dense.median3(x)))


def test_disparity_to_depth_u8(rng):
    d = rng.uniform(-3, 70, (19, 29)).astype(np.float32)
    np.testing.assert_array_equal(
        np_(dense.disparity_to_depth_u8(_t(d), 64)),
        np_(ref_dense.disparity_to_depth_u8(jnp.asarray(d), 64)),
    )


@pytest.mark.parametrize("shape", [(32, 48), (33, 49), (7, 6)])
def test_downsample2_bit_equal(rng, shape):
    g = rng.uniform(0, 255, shape).astype(np.float32)
    np.testing.assert_array_equal(
        np_(pyramid.downsample2(_t(g))), np_(ref_pyramid.downsample2(jnp.asarray(g)))
    )


@pytest.mark.parametrize("hw", [(32, 48), (33, 49), (32, 49), (33, 48)])
def test_upsample2_disparity_bit_equal(rng, hw):
    h, w = hw
    d = rng.uniform(0, 20, (h // 2, w // 2)).astype(np.float32)
    np.testing.assert_array_equal(
        np_(pyramid.upsample2_disparity(_t(d), h, w)),
        np_(ref_pyramid.upsample2_disparity(jnp.asarray(d), h, w)),
    )

"""Plain PyTorch dense matcher and pyramid helpers vs the JAX reference.

Pyramid helpers and the median are selections or fixed-order adds, so they
must agree bit for bit; the rest agree to f32 rounding (rtol 1e-5: cumulative
sums run in another order)."""

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
from tests.torch_port import np_


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
    with pytest.raises(ValueError, match="device"):
        dense.grayscale(rng.uniform(0, 1, (4, 4)))


@pytest.mark.parametrize("cost", ["sad", "ssd"])
def test_cost_volume(rng, cost):
    left, right = make_pair(rng, h=24, w=40, shift=3)
    lg, rg = left.astype(np.float32), right.astype(np.float32)
    cfg = dict(num_disparities=8, cost=cost)
    want = ref_dense.cost_volume(jnp.asarray(lg), jnp.asarray(rg), RefMatchConfig(**cfg))
    got = dense.cost_volume(_t(lg), _t(rg), MatchConfig(**cfg))
    np.testing.assert_allclose(np_(got), np_(want), rtol=1e-5)


def test_cost_volume_census_waits_for_slice_2(rng):
    g = _t(rng.uniform(0, 255, (8, 8)).astype(np.float32))
    with pytest.raises(NotImplementedError, match="slice 2"):
        dense.cost_volume(g, g, MatchConfig(cost="census"))


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

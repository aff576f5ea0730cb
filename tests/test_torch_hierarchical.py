"""The port's ``hierarchical`` backend (``stepth_tpu_torch.match.pyramid``)
against the JAX package's ``match.pyramid``: bit for bit on integer gray
pairs (every cost and box sum then takes the reference's values; the
out-of-image ``1e6`` costs make the sums inexact, so their order is the
reference's), and under the rule of ``tests/test_pallas_dense.py:15-24``
on float images."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stepth_tpu.config import MatchConfig as RefMatchConfig
from stepth_tpu.config import PyramidConfig as RefPyramidConfig
from stepth_tpu.match import dense as ref_dense
from stepth_tpu.match import pyramid as ref_pyramid
from stepth_tpu.match.sgm import SGMConfig as RefSGMConfig
from stepth_tpu.models import StereoModel as RefStereoModel
from stepth_tpu_torch.config import MatchConfig, PyramidConfig, SGMConfig
from stepth_tpu_torch.match import pyramid
from stepth_tpu_torch.models import StereoModel
from stepth_tpu_torch.utils import scenes

from tests.test_match_dense import make_pair
from tests.torch_port import assert_close, cuda, np_, one_torch_thread  # noqa: F401 (fixtures)

# tests/test_match_dense.py:123-133
CFG = dict(num_disparities=32, window=9)
PYR = dict(levels=3, refine_radius=3, coarsest_disparities=8)


# the reference's level as one program (op by op, its tilings take ~5 s a call)
_ref_refine = jax.jit(ref_pyramid._refine_level,
                      static_argnames=("cfg", "radius", "max_base", "max_windows"))


def _int_pair(rng, h=96, w=128, shift=10):
    left, right = make_pair(rng, h=h, w=w, shift=shift)
    return np.round(left).astype(np.float32), np.round(right).astype(np.float32)


def _equal(want, got):
    np.testing.assert_array_equal(np_(got.disparity), np_(want.disparity))
    np.testing.assert_array_equal(np_(got.valid), np_(want.valid))
    np.testing.assert_array_equal(np_(got.cost), np_(want.cost))


@pytest.mark.parametrize("coarse", ["wta", "sgm"])
def test_integer_gray_bit_equal(rng, coarse):
    left, right = _int_pair(rng)
    sgm = dict(directions=4)
    want = ref_pyramid.match_hierarchical(
        jnp.asarray(left), jnp.asarray(right), RefMatchConfig(**CFG), RefPyramidConfig(**PYR),
        coarse_backend=coarse, sgm=RefSGMConfig(**sgm) if coarse == "sgm" else None)
    got = pyramid.match_hierarchical(left, right, MatchConfig(**CFG), PyramidConfig(**PYR),
                                     coarse_backend=coarse, sgm=SGMConfig(**sgm), device="cpu")
    _equal(want, got)
    err = np.abs(np_(got.disparity)[12:-12, 12:-12] - 10)
    assert np.median(err) <= 1.0


def test_refine_level_on_noisy_step_prior(rng):
    """One level alone: a noisy prior with a disparity step inside the
    tiles, so they plan several windows (max_windows=4), bit for bit."""
    left, right = _int_pair(rng, shift=12)
    prior = np.where(np.arange(128)[None, :] < 70, 12.0, 4.0).astype(np.float32)
    prior = prior + rng.normal(0.0, 1.5, (96, 128)).astype(np.float32)
    for radius, windows in ((2, 4), (3, 1)):
        want = _ref_refine(jnp.asarray(left), jnp.asarray(right), jnp.asarray(prior),
                           cfg=RefMatchConfig(**CFG), radius=radius, max_base=32,
                           max_windows=windows)
        got = pyramid._refine_level(torch.from_numpy(left), torch.from_numpy(right),
                                    torch.from_numpy(prior), MatchConfig(**CFG), radius,
                                    max_base=32, max_windows=windows)
        np.testing.assert_array_equal(np_(got), np_(want))
    nosub = _ref_refine(jnp.asarray(left), jnp.asarray(right), jnp.asarray(prior),
                        cfg=RefMatchConfig(subpixel=False, **CFG), radius=2, max_base=32,
                        max_windows=4)
    got = pyramid._refine_level(torch.from_numpy(left), torch.from_numpy(right),
                                torch.from_numpy(prior), MatchConfig(subpixel=False, **CFG), 2,
                                max_base=32, max_windows=4)
    np.testing.assert_array_equal(np_(got), np_(nosub))


def test_blocked_cumsum_is_the_references(rng):
    """The box sums over costs holding 1e6 equal the reference's bit for
    bit (its prefix sums run in 16-element blocks), on lengths below, at and
    past one and two block levels."""
    for shape in ((24, 40, 5), (7, 300, 3), (33, 16, 2)):
        cost = rng.uniform(0, 255, shape).astype(np.float32)
        cost[rng.uniform(size=shape) < 0.2] = 1e6
        for window in (1, 5, 9):
            want = ref_dense.box_aggregate(jnp.asarray(cost), window)
            got = pyramid._box_sum(torch.from_numpy(cost), window)
            np.testing.assert_array_equal(np_(got), np_(want))


def test_rgb_and_box_scene_within_tolerance():
    """Float images, bit for bit: gray and RGB ``make_pair`` at 96×128,
    seeds 0-2 (this file's config), and the ``box`` (tiles that plan
    several windows at its depth edges) and ``slant`` scenes at 270×480,
    D=64, ``levels=3``, ``coarsest_disparities=16``, seed 2."""
    pairs = []
    for seed in range(3):
        left, right = make_pair(np.random.default_rng(seed), h=96, w=128, shift=10)
        rgb_l = np.stack([left, 0.8 * left + 20.0, 255.0 - left], -1).astype(np.float32)
        rgb_r = np.stack([right, 0.8 * right + 20.0, 255.0 - right], -1).astype(np.float32)
        pairs += [(left, right, CFG, PYR), (rgb_l, rgb_r, CFG, PYR)]
    scene_cfg = dict(num_disparities=64, window=9)
    scene_pyr = dict(levels=3, refine_radius=3, coarsest_disparities=16)
    for name in ("box", "slant"):
        sc = scenes.make_scene(name, 270, 480, 64, seed=2)
        pairs.append((sc.left, sc.right, scene_cfg, scene_pyr))
    for l, r, cfg, pyr in pairs:
        want = ref_pyramid.match_hierarchical(jnp.asarray(l), jnp.asarray(r),
                                              RefMatchConfig(**cfg), RefPyramidConfig(**pyr))
        got = pyramid.match_hierarchical(l, r, MatchConfig(**cfg), PyramidConfig(**pyr),
                                         device="cpu")
        np.testing.assert_array_equal(np_(got.disparity), np_(want.disparity))
        np.testing.assert_array_equal(np_(got.valid), np_(want.valid))


def test_model_backend_matches_reference(rng):
    left, right = _int_pair(rng)
    kw = dict(backend="hierarchical")
    want = RefStereoModel(match=RefMatchConfig(**CFG), pyramid=RefPyramidConfig(**PYR),
                          **kw)(jnp.asarray(left), jnp.asarray(right))
    model = StereoModel(match=MatchConfig(**CFG), pyramid=PyramidConfig(**PYR), **kw)
    _equal(want, model(torch.from_numpy(left), torch.from_numpy(right)))
    with pytest.raises(NotImplementedError, match="sharded"):
        model.sharded(None)
    with pytest.raises(ValueError, match="coarse_backend"):
        pyramid.match_hierarchical(left, right, coarse_backend="nope", device="cpu")


@pytest.mark.cuda
def test_card_matches_cpu(cuda, rng):
    left, right = _int_pair(rng)
    got = pyramid.match_hierarchical(left, right, MatchConfig(**CFG), PyramidConfig(**PYR),
                                     device=cuda)
    want = pyramid.match_hierarchical(left, right, MatchConfig(**CFG), PyramidConfig(**PYR),
                                      device="cpu")
    assert_close(np_(want.disparity), np_(want.valid), np_(got.disparity), np_(got.valid))

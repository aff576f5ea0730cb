"""K2, the tile-base refine kernel, and its window plan.

The plan (``tile_windows_from_prior``) must equal the reference's as
integers. The plain ``refine_level`` is held to
``pallas_refine.refine_level(interpret=True)`` with the "close" rule, and (on
a card) the CUDA kernel to the plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stepth_tpu.config import MatchConfig as RefMatchConfig
from stepth_tpu.match import pallas_refine
from stepth_tpu_torch.config import MatchConfig
from stepth_tpu_torch.match import fused_refine

from tests.test_match_dense import make_pair
from tests.torch_port import assert_close, cuda, np_  # noqa: F401 (fixture)

SHIFT = 6


def _prior(rng, kind, h, w):
    """smooth: the true shift plus unit noise; step: a +10 px jump inside
    the first 128-column tile and another in the second (so nw > 1)."""
    prior = np.full((h, w), float(SHIFT), np.float32)
    prior += rng.normal(0, 1.0, (h, w)).astype(np.float32)
    if kind == "step":
        prior[:, 60:] += 10.0
        prior[h // 2 :, 200:] -= 7.0
    return prior


def _plans_equal(prior, tile_rows, max_base, radius, max_windows):
    want_b, want_n = pallas_refine.tile_windows_from_prior(
        jnp.asarray(prior), tile_rows, max_base, radius, max_windows
    )
    got_b, got_n = fused_refine.tile_windows_from_prior(
        torch.from_numpy(prior), tile_rows, max_base, radius, max_windows
    )
    np.testing.assert_array_equal(np_(got_b), np_(want_b))
    np.testing.assert_array_equal(np_(got_n), np_(want_n))
    assert got_b.dtype == got_n.dtype == torch.int32
    return np_(got_n)


@pytest.mark.parametrize("radius", [2, 4])
@pytest.mark.parametrize("kind", ["smooth", "step"])
def test_plan_equals_reference(rng, kind, radius):
    prior = _prior(rng, kind, 64, 256)
    for tile_rows, max_windows in ((32, 16), (64, 4), (16, 1)):
        nw = _plans_equal(prior, tile_rows, 32, radius, max_windows)
        if kind == "step" and max_windows > 1:
            assert nw.max() > 1  # the multi-window path is exercised


def test_plan_equals_reference_on_ramps_and_offsets(rng):
    """A linear ramp (windows tiled across its span) and half-integer
    constant priors (round-half-even at the tile mean)."""
    ramp = np.broadcast_to(np.linspace(0, 60, 256, dtype=np.float32), (32, 256)).copy()
    _plans_equal(ramp, 32, 64, 2, 16)
    _plans_equal(np.full((32, 256), 12.5, np.float32), 32, 64, 2, 16)
    _plans_equal(np.full((32, 256), 13.5, np.float32), 32, 64, 2, 16)


@pytest.mark.parametrize("max_base, radius", [(16, 2), (64, 2), (32, 4), (128, 2)])
def test_plan_equals_reference_at_cover_bound(rng, max_base, radius):
    """Adversarial priors past both ends of [0, max_base]: the K clamp at
    ceil((max_base+1)/(2R+1)) and the clip of bases to the valid range."""
    bound = -(-(max_base + 1) // (2 * radius + 1))
    for max_windows in (64, 16):
        prior = rng.uniform(-5, max_base + 5, (32, 256)).astype(np.float32)
        nw = _plans_equal(prior, 16, max_base, radius, max_windows)
        assert nw.max() <= bound


@pytest.mark.parametrize("kind", ["smooth", "step"])
@pytest.mark.parametrize("max_windows", [1, 16])
@pytest.mark.parametrize("radius", [2, 4])
def test_plain_refine_matches_pallas(rng, radius, max_windows, kind):
    left, right = make_pair(rng, h=64, w=256, shift=SHIFT)
    lg, rg = left.astype(np.float32), right.astype(np.float32)
    prior = _prior(rng, kind, 64, 256)
    args = dict(radius=radius, max_base=32, tile_rows=32, max_windows=max_windows)
    want = pallas_refine.refine_level(
        jnp.asarray(lg), jnp.asarray(rg), jnp.asarray(prior), RefMatchConfig(window=9),
        interpret=True, **args,
    )
    got = fused_refine.refine_level(
        torch.from_numpy(lg), torch.from_numpy(rg), torch.from_numpy(prior),
        MatchConfig(window=9), **args,
    )
    everywhere = np.ones(lg.shape, bool)
    assert_close(np_(want), everywhere, np_(got), everywhere)


def test_plain_refine_ssd_row_window_matches_pallas(rng):
    """SSD cost, window 5, an unaligned shape and a row-shard window."""
    left, right = make_pair(rng, h=50, w=130, shift=SHIFT)
    lg, rg = left.astype(np.float32), right.astype(np.float32)
    prior = _prior(rng, "step", 50, 130)
    cfg = dict(window=5, cost="ssd")
    args = dict(radius=2, max_base=32, tile_rows=24, max_windows=16, g_row0=-3, g_h=40)
    want = pallas_refine.refine_level(
        jnp.asarray(lg), jnp.asarray(rg), jnp.asarray(prior), RefMatchConfig(**cfg),
        interpret=True, **args,
    )
    got = fused_refine.refine_level(
        torch.from_numpy(lg), torch.from_numpy(rg), torch.from_numpy(prior),
        MatchConfig(**cfg), **args,
    )
    everywhere = np.ones(lg.shape, bool)
    assert_close(np_(want), everywhere, np_(got), everywhere)


def test_right_view_waits_for_slice_2():
    g = torch.zeros((16, 128))
    with pytest.raises(NotImplementedError, match="slice 2"):
        fused_refine.refine_level(g, g, g, MatchConfig(), 2, 16, lr=True)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["smooth", "step"])
def test_kernel_matches_plain_on_card(cuda, kind):
    rng = np.random.default_rng(7)
    left, right = make_pair(rng, h=270, w=480, shift=SHIFT)
    lg = torch.as_tensor(left, dtype=torch.float32, device=cuda).contiguous()
    rg = torch.as_tensor(right, dtype=torch.float32, device=cuda).contiguous()
    prior = torch.as_tensor(_prior(rng, kind, 270, 480), device=cuda)
    args = (MatchConfig(window=9), 2, 32, 64)
    before = fused_refine.K2.launches
    got = fused_refine.refine_level(lg, rg, prior, *args, max_windows=16)
    torch.cuda.synchronize()
    assert fused_refine.K2.launches == before + 1
    want = fused_refine.refine_level_plain(lg, rg, prior, *args, max_windows=16)
    everywhere = np.ones(lg.shape, bool)
    assert_close(np_(want), everywhere, np_(got), everywhere)

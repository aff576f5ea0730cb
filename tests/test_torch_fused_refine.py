"""K2, the tile-base refine kernel, and its window plan.

The plan (``tile_windows_from_prior``) must equal the reference's as
integers. The plain ``refine_level`` is held to
``pallas_refine.refine_level(interpret=True)``: with the "close" rule in the
SAD/SSD cases, exactly (disparity and right view) for census and
``lr=True``; on a card, the CUDA kernel to the plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stepth_tpu.config import MatchConfig as RefMatchConfig
from stepth_tpu.match import pallas_refine
from stepth_tpu_torch.config import MatchConfig, PyramidConfig
from stepth_tpu_torch.match import fused_refine, pyramid
from stepth_tpu_torch.utils import scenes

from tests.test_match_dense import make_pair
from tests.test_torch_refine_plan import plan_prior
from tests.torch_port import assert_close, cuda, np_, one_torch_thread  # noqa: F401 (fixtures)

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


@pytest.mark.parametrize("radius", [2, 4])
@pytest.mark.parametrize("kind", ["halves", "groups"])
def test_plan_equals_reference_on_ties(kind, radius):
    """Integer priors: tile means exactly on a half (round-half-even of the
    mean), and covers whose window midpoints fall on halves and that end
    before K windows (every later slot the 1e30 sentinel's base)."""
    early = 0
    for tile_rows, max_base in ((16, 64), (24, 32), (32, 128)):
        prior = plan_prior(kind, 2 * tile_rows, 384, max_base).numpy()
        nw = _plans_equal(prior, tile_rows, max_base, radius, 16)
        K = min(16, -(-(max_base + 1) // (2 * radius + 1)))
        early += int(((nw > 1) & (nw < K)).sum())
        if kind == "halves":
            means = prior.reshape(2, tile_rows, 3, 128).mean(axis=(1, 3))
            assert (means % 1 == 0.5).all()
    assert early > 0 if kind == "groups" else early == 0


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


def _refine_both(lg, rg, prior, cfg, **args):
    want = pallas_refine.refine_level(
        jnp.asarray(lg), jnp.asarray(rg), jnp.asarray(prior), RefMatchConfig(**cfg),
        interpret=True, **args,
    )
    got = fused_refine.refine_level(
        torch.from_numpy(lg), torch.from_numpy(rg), torch.from_numpy(prior),
        MatchConfig(**cfg), **args,
    )
    return want, got


@pytest.mark.parametrize("kind", ["smooth", "step", "noise"])
def test_right_view_matches_pallas(rng, kind):
    """``lr=True``: both outputs exactly equal. The right view comes from each
    tile's whole 256-column cost region with circular box sums: a port that
    adds only the tile's own output columns, or zero-pads the region, fails
    the step prior (a tile with nw = 2) and the white-noise texture."""
    h, w = 32, 384
    if kind == "noise":
        tex = rng.uniform(0, 255, (h, w + SHIFT)).astype(np.float32)
        lg, rg = tex[:, :w], np.ascontiguousarray(tex[:, SHIFT:])
    else:
        left, right = make_pair(rng, h=h, w=w, shift=SHIFT)
        lg, rg = left.astype(np.float32), right.astype(np.float32)
    prior = _prior(rng, "step" if kind == "step" else "smooth", h, w)
    args = dict(radius=2, max_base=32, tile_rows=32, max_windows=16, lr=True)
    (want_d, want_r), (got_d, got_r) = _refine_both(lg, rg, prior, dict(window=9), **args)
    np.testing.assert_array_equal(np_(got_d), np_(want_d))
    np.testing.assert_array_equal(np_(got_r), np_(want_r))
    assert (np_(want_r) == -1e6).any() and (np_(want_r) > -1e6).mean() > 0.9
    if kind == "step":
        _, nw, _ = fused_refine.plan_level(torch.from_numpy(prior), 32, 32, 2, 16)
        assert int(nw.max()) > 1
    # the forward disparity is the lr=False one
    np.testing.assert_array_equal(np_(got_d), np_(fused_refine.refine_level(
        torch.from_numpy(lg), torch.from_numpy(rg), torch.from_numpy(prior),
        MatchConfig(window=9), 2, 32, 32, max_windows=16)))


@pytest.mark.parametrize("census_window", [5, 7])
def test_census_refine_matches_pallas_exactly(rng, census_window):
    left, right = make_pair(rng, h=64, w=256, shift=SHIFT)
    lg, rg = left.astype(np.float32), right.astype(np.float32)
    prior = _prior(rng, "step", 64, 256)
    cfg = dict(window=9, cost="census", census_window=census_window)
    want, got = _refine_both(lg, rg, prior, cfg, radius=2, max_base=32, tile_rows=32,
                             max_windows=16)
    np.testing.assert_array_equal(np_(got), np_(want))


def test_census_right_view_r4_row_window_matches_pallas(rng):
    """Census window 5 with R=4, window 7, an unaligned shape, tile_rows
    rounded up from 20 and a row-shard window, both outputs exact."""
    left, right = make_pair(rng, h=50, w=200, shift=SHIFT)
    lg, rg = left.astype(np.float32), right.astype(np.float32)
    prior = _prior(rng, "step", 50, 200)
    cfg = dict(window=7, cost="census", census_window=5)
    args = dict(radius=4, max_base=32, tile_rows=20, max_windows=16, g_row0=-3, g_h=40,
                lr=True)
    (want_d, want_r), (got_d, got_r) = _refine_both(lg, rg, prior, cfg, **args)
    np.testing.assert_array_equal(np_(got_d), np_(want_d))
    np.testing.assert_array_equal(np_(got_r), np_(want_r))


@pytest.mark.parametrize("scene", ["shifted", "box"])
def test_plans_equal_on_census_scenes(rng, scene):
    """The tile means of the plan sum in another order than XLA's CPU reduce
    (ROADMAP Queue 3); on the production path's census priors every level's
    plan still equals the reference's."""
    if scene == "box":
        sc = scenes.make_scene("box", 96, 256, 32, seed=1)
        left, right = sc.left, sc.right
    else:
        left, right = make_pair(rng, h=96, w=256, shift=10)
    cfg = MatchConfig(num_disparities=32, window=9, cost="census")
    pyr = PyramidConfig(levels=3, coarsest_disparities=8)
    lefts = [torch.as_tensor(left, dtype=torch.float32)]
    rights = [torch.as_tensor(right, dtype=torch.float32)]
    for _ in range(pyr.levels - 1):
        lefts.append(pyramid.downsample2(lefts[-1]))
        rights.append(pyramid.downsample2(rights[-1]))
    coarse = MatchConfig(num_disparities=8, window=9, cost="census", lr_threshold=None)
    disp = fused_refine.PLAIN.match(lefts[-1], rights[-1], coarse)[0]
    max_base, multi = 8, 0
    for lvl in (1, 0):
        h, w = lefts[lvl].shape
        prior = np_(pyramid.upsample2_disparity(disp, h, w))
        max_base *= 2
        padded = np.pad(prior, ((0, -h % 64), (0, -w % 128)), mode="edge")
        multi += int((_plans_equal(padded, 64, max_base, 2, 16) > 1).sum())
        disp = fused_refine.refine_level(lefts[lvl], rights[lvl], torch.from_numpy(prior),
                                         cfg, 2, max_base, 64, max_windows=16)
    if scene == "box":
        assert multi > 0


# Plans the prior never gives (h, w, R, tile_rows, kind): base windows at
# negative disparities, at and beyond w - R, nw = 0 (window 0 still runs)
# and nw above K (clamped to K); tile_rows 8 and 24
PLAN_EDGES = [
    (24, 200, 2, 8, "negative"),
    (24, 200, 2, 8, "beyond"),
    (24, 200, 1, 8, "nw0"),
    (24, 200, 4, 24, "nwK"),
]


def _edge_plan(rng, h, w, tile_rows, kind, K=4):
    nr, nc = -(-h // tile_rows), -(-w // 128)
    bases = rng.integers(0, 40, (nr, nc, K)).astype(np.int32)
    nw = rng.integers(1, K + 1, (nr, nc)).astype(np.int32)
    if kind == "negative":
        bases[..., 0] = -3
        bases[0, 0, 1] = -1
    elif kind == "beyond":
        bases[..., 0] = w - 1
        bases[0, -1, 1] = w + 3
        nw[:] = 2
    elif kind == "nw0":
        nw[:] = 0
    else:
        nw[:] = K + 2
    return bases, nw


@pytest.mark.parametrize("lr", [False, True])
@pytest.mark.parametrize("h, w, radius, tile_rows, kind", PLAN_EDGES)
def test_given_plan_matches_pallas(rng, monkeypatch, h, w, radius, tile_rows, kind, lr):
    """K2's plain version on a given plan, both outputs exactly equal to the
    reference kernel run on the same plan (its planner replaced), census."""
    left = rng.integers(0, 256, (h, w)).astype(np.float32)
    right = np.roll(left, -SHIFT, axis=1)
    bases, nw = _edge_plan(rng, h, w, tile_rows, kind)
    monkeypatch.setattr(pallas_refine, "tile_windows_from_prior",
                        lambda *a, **k: (jnp.asarray(bases), jnp.asarray(nw)))
    cfg = dict(window=9, cost="census", census_window=7)
    want = pallas_refine.refine_level(
        jnp.asarray(left), jnp.asarray(right), jnp.zeros((h, w), jnp.float32),
        RefMatchConfig(**cfg), radius, 256, tile_rows, interpret=True, lr=lr,
        max_windows=bases.shape[-1])
    got = fused_refine.refine_planned(torch.from_numpy(left), torch.from_numpy(right),
                                      torch.from_numpy(bases), torch.from_numpy(nw),
                                      MatchConfig(**cfg), radius, tile_rows, lr=lr)
    for a, b in zip(want, got) if lr else ((want, got),):
        np.testing.assert_array_equal(np_(b), np_(a))


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


@pytest.mark.cuda
def test_census_right_view_kernel_matches_plain_on_card(cuda):
    rng = np.random.default_rng(7)
    left, right = make_pair(rng, h=270, w=480, shift=SHIFT)
    lg = torch.as_tensor(left, dtype=torch.float32, device=cuda).contiguous()
    rg = torch.as_tensor(right, dtype=torch.float32, device=cuda).contiguous()
    prior = torch.as_tensor(_prior(rng, "step", 270, 480), device=cuda)
    args = (MatchConfig(window=9, cost="census"), 2, 32, 64)
    before = (fused_refine.K2.launches, fused_refine.K2_EMIT.launches)
    got = fused_refine.refine_level(lg, rg, prior, *args, max_windows=16, lr=True)
    torch.cuda.synchronize()
    assert (fused_refine.K2.launches, fused_refine.K2_EMIT.launches) == (
        before[0] + 1, before[1] + 1)
    want = fused_refine.refine_level_plain(lg, rg, prior, *args, max_windows=16, lr=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("lr", [False, True])
@pytest.mark.parametrize("cost", ["sad", "census"])
@pytest.mark.parametrize("h, w, radius, tile_rows, kind",
                         PLAN_EDGES + [(72, 130, 2, 64, "negative"), (20, 100, 2, 8, "nwK")])
@pytest.mark.parametrize("census_window", [7, 13])
def test_given_plan_kernel_matches_plain_on_card(cuda, h, w, radius, tile_rows, kind, cost,
                                                 lr, census_window):
    """K2 (and its right-view emit) bit-equal to the plain version on the
    edge plans, on float images, also at w = 130 and w < 128, and with 6
    census planes (census window 13: with the right view the tiles do not
    fit in shared memory and the images are read from global memory)."""
    rng = np.random.default_rng(13)
    left = rng.uniform(0, 255, (h, w)).astype(np.float32)
    right = np.roll(left, -SHIFT, axis=1) + rng.uniform(0, 3, (h, w)).astype(np.float32)
    bases, nw = _edge_plan(rng, h, w, tile_rows, kind)
    args = (torch.as_tensor(left, device=cuda), torch.as_tensor(right, device=cuda),
            torch.as_tensor(bases, device=cuda), torch.as_tensor(nw, device=cuda),
            MatchConfig(window=9, cost=cost, census_window=census_window), radius, tile_rows)
    got = fused_refine.refine_planned(*args, lr=lr)
    want = fused_refine.refine_planned_plain(*args, lr=lr)
    torch.cuda.synchronize()
    for a, b in zip(want, got) if lr else ((want, got),):
        assert torch.equal(a, b)

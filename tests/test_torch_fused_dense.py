"""K1, the fused exhaustive matcher: its plain version vs
``pallas_dense.raw_match(interpret=True)``, and (on a card) the CUDA kernel
vs the plain version. Tolerance: the reference's "close" rule on the
disparities (tests/torch_port.assert_close), rtol 1e-5 on the best cost, for
the SAD/SSD cases; exact equality of all four outputs for census,
the LR check and ``match_pair_fused`` (the ``pallas`` backend), where the
box sums add the same values in the same order as the reference."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stepth_tpu.config import MatchConfig as RefMatchConfig
from stepth_tpu.match import pallas_dense
from stepth_tpu_torch.config import MatchConfig
from stepth_tpu_torch.match import fused_dense

from tests.test_match_dense import make_pair
from tests.torch_port import assert_close, cuda, np_, one_torch_thread  # noqa: F401 (fixtures)


def _outputs_close(ref, got):
    disp, disp_r, cbest, valid = (np_(a) for a in ref)
    g_disp, g_disp_r, g_cbest, g_valid = (np_(a) for a in got)
    assert_close(disp, valid > 0.5, g_disp, g_valid > 0.5)
    everywhere = np.ones(disp.shape, bool)
    assert_close(disp_r, everywhere, g_disp_r, everywhere)
    np.testing.assert_allclose(g_cbest, cbest, rtol=1e-5)


@pytest.mark.parametrize("uniqueness", [None, 0.1])
@pytest.mark.parametrize("cost", ["sad", "ssd"])
@pytest.mark.parametrize("window", [9, 5])
@pytest.mark.parametrize("h, w, d", [(48, 160, 16), (50, 130, 8)])
def test_plain_matches_pallas(rng, h, w, d, window, cost, uniqueness):
    left, right = make_pair(rng, h=h, w=w, shift=5)
    lg, rg = left.astype(np.float32), right.astype(np.float32)
    cfg = dict(num_disparities=d, window=window, cost=cost, lr_threshold=None,
               uniqueness=uniqueness)
    ref = pallas_dense.raw_match(
        jnp.asarray(lg), jnp.asarray(rg), RefMatchConfig(**cfg), interpret=True
    )
    got = fused_dense.raw_match(torch.from_numpy(lg), torch.from_numpy(rg),
                                MatchConfig(**cfg))
    _outputs_close(ref, got)


def test_row_window_matches_pallas(rng):
    """``g_row0``/``g_h``: a halo-extended row shard costs only global rows."""
    left, right = make_pair(rng, h=40, w=130, shift=4)
    lg, rg = left.astype(np.float32), right.astype(np.float32)
    cfg = dict(num_disparities=8, window=9, lr_threshold=None)
    ref = pallas_dense.raw_match(jnp.asarray(lg), jnp.asarray(rg), RefMatchConfig(**cfg),
                                 interpret=True, g_row0=-4, g_h=30)
    got = fused_dense.raw_match(torch.from_numpy(lg), torch.from_numpy(rg),
                                MatchConfig(**cfg), g_row0=-4, g_h=30)
    _outputs_close(ref, got)


def _outputs_equal(ref, got):
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(np_(b), np_(a))


@pytest.mark.parametrize(
    "cfg", [dict(lr_threshold=1.0), dict(cost="census", lr_threshold=None)],
    ids=["lr", "census"],
)
def test_slice_2_features_match_pallas(rng, cfg):
    """The LR check (the fourth output, K4 after K1) and census planes."""
    left, right = make_pair(rng, h=48, w=160, shift=5)
    lg, rg = left.astype(np.float32), right.astype(np.float32)
    cfg = dict(num_disparities=16, window=9, **cfg)
    ref = pallas_dense.raw_match(jnp.asarray(lg), jnp.asarray(rg), RefMatchConfig(**cfg),
                                 interpret=True)
    got = fused_dense.raw_match(torch.from_numpy(lg), torch.from_numpy(rg), MatchConfig(**cfg))
    _outputs_equal(ref, got)
    if cfg.get("lr_threshold"):
        assert 0.5 < np_(got[3]).mean() < 1  # the check rejects some pixels


@pytest.mark.parametrize("lr_threshold", [None, 1.0])
@pytest.mark.parametrize("uniqueness", [None, 0.1])
@pytest.mark.parametrize("census_window", [5, 7])
def test_census_matches_pallas_exactly(rng, census_window, uniqueness, lr_threshold):
    """Census K1 (one plane for window 5, two for 7), unaligned shape, with
    uniqueness and the LR check."""
    left, right = make_pair(rng, h=50, w=130, shift=4)
    lg, rg = left.astype(np.float32), right.astype(np.float32)
    cfg = dict(num_disparities=16, window=9, cost="census", census_window=census_window,
               uniqueness=uniqueness, lr_threshold=lr_threshold)
    ref = pallas_dense.raw_match(jnp.asarray(lg), jnp.asarray(rg), RefMatchConfig(**cfg),
                                 interpret=True)
    got = fused_dense.raw_match(torch.from_numpy(lg), torch.from_numpy(rg), MatchConfig(**cfg))
    _outputs_equal(ref, got)


@pytest.mark.parametrize("cost", ["sad", "census"])
def test_match_pair_fused_matches_pallas(rng, cost):
    """The ``pallas`` backend's pipeline: K1 (+ K4), K5, K3."""
    left, right = make_pair(rng, h=48, w=160, shift=6)
    cfg = dict(num_disparities=32, window=9, cost=cost, lr_threshold=1.0)
    ref = pallas_dense.match_pair_pallas(left, right, RefMatchConfig(**cfg), interpret=True)
    got = fused_dense.match_pair_fused(left, right, MatchConfig(**cfg), device="cpu")
    _outputs_equal(ref, got)
    _outputs_equal(got, fused_dense.match_pair_plain(torch.from_numpy(left),
                                                     torch.from_numpy(right), MatchConfig(**cfg)))


@pytest.mark.cuda
@pytest.mark.parametrize("uniqueness", [None, 0.1])
def test_kernel_matches_plain_on_card(cuda, uniqueness):
    """K1 at the main path's coarse shape (135×240, D=16)."""
    rng = np.random.default_rng(3)
    left, right = make_pair(rng, h=135, w=240, shift=5)
    lg = torch.as_tensor(left, dtype=torch.float32, device=cuda).contiguous()
    rg = torch.as_tensor(right, dtype=torch.float32, device=cuda).contiguous()
    cfg = MatchConfig(num_disparities=16, window=9, lr_threshold=None, uniqueness=uniqueness)
    before = fused_dense.K1.launches
    got = fused_dense.raw_match(lg, rg, cfg)
    torch.cuda.synchronize()
    assert fused_dense.K1.launches == before + 1
    _outputs_close(fused_dense.raw_match_plain(lg, rg, cfg), got)


@pytest.mark.cuda
@pytest.mark.parametrize("cost, d, h, w", [("census", 16, 135, 240), ("sad", 128, 1080, 1920)])
def test_census_and_lr_kernel_match_plain_on_card(cuda, cost, d, h, w):
    """K1 with census planes at the production coarse shape, and at full
    resolution with D=128 and the LR check (``flagship``)."""
    rng = np.random.default_rng(3)
    left, right = make_pair(rng, h=h, w=w, shift=5)
    lg = torch.as_tensor(left, dtype=torch.float32, device=cuda).contiguous()
    rg = torch.as_tensor(right, dtype=torch.float32, device=cuda).contiguous()
    cfg = MatchConfig(num_disparities=d, window=9, cost=cost, lr_threshold=1.0)
    got = fused_dense.raw_match(lg, rg, cfg)
    torch.cuda.synchronize()
    _outputs_equal(fused_dense.raw_match_plain(lg, rg, cfg), got)


# ---- the right view's merge across blocks ----------------------------------


def _merged_right_view(lg, rg, cfg, block):
    """K1's right view as the kernel merges it: each block of ``block``
    columns keeps, per (row, u), the minimum of the packed keys ``(f32 bits
    << 32) | d`` that its own columns x = u + d offer; the blocks' minima
    are then merged by a packed u64 minimum from the start value (BIG at
    d = 0). Returns the low words, the disparities, as f32[H, W]."""
    planes, row_ok = fused_dense.cost_inputs(lg, rg, cfg)
    h, w = lg.shape
    costs = [fused_dense.box_cost(lg, rg, planes, cfg, d, row_ok)
             for d in range(cfg.num_disparities)]
    merged = torch.full((h, w), fused_dense._RIGHT_START, dtype=torch.int64)
    for x0 in range(0, w, block):
        part = torch.full((h, w), fused_dense._RIGHT_START, dtype=torch.int64)
        for d, cost in enumerate(costs):
            if max(x0, d) >= min(x0 + block, w):
                continue
            xs = torch.arange(max(x0, d), min(x0 + block, w))
            key = (cost[:, xs].contiguous().view(torch.int32).to(torch.int64) << 32) | d
            part[:, xs - d] = torch.minimum(part[:, xs - d], key)
        merged = torch.minimum(merged, part)
    return (merged & 0xFFFFFFFF).to(torch.float32)


@pytest.mark.parametrize("block", [8, 24, 56, 128])
@pytest.mark.parametrize("cost", ["sad", "census"])
def test_right_view_block_merge_matches_plain(rng, cost, block):
    """The per-block minima and their packed u64 merge give the plain
    version's right view, for blocks narrower than D (40) and one block
    wider than the image."""
    left, right = make_pair(rng, h=20, w=100, shift=33)
    lg, rg = torch.from_numpy(left.astype(np.float32)), torch.from_numpy(right.astype(np.float32))
    cfg = MatchConfig(num_disparities=40, window=9, cost=cost, census_window=5,
                      lr_threshold=None)
    want = fused_dense.raw_match_plain(lg, rg, cfg)[1]
    assert (want > 20).float().mean() > 0.5  # most winners lie in other blocks
    np.testing.assert_array_equal(np_(_merged_right_view(lg, rg, cfg, block)), np_(want))


# K1's edge cases on the card (``chip_smoke.K1_EDGES`` repeats them there):
# (h, w, D, window, cost, census_window, uniqueness, g_row0, g_h, shift)
K1_EDGES = [
    (37, 300, 1, 9, "sad", 7, None, 0, None, 0),
    (40, 100, 16, 9, "census", 5, 0.1, 0, None, 5),
    (40, 300, 127, 9, "sad", 7, None, 0, None, 120),
    (33, 257, 128, 9, "census", 7, 0.1, 0, None, 100),
    (20, 100, 129, 7, "ssd", 7, None, 0, None, 30),
    (24, 150, 200, 5, "census", 9, None, 0, None, 140),
    (50, 260, 64, 9, "sad", 7, 0.1, -8, 38, 60),
    (45, 131, 48, 9, "census", 7, None, -3, 40, 40),
    (1080, 515, 129, 9, "census", 9, 0.1, 0, None, 100),
]


@pytest.mark.cuda
@pytest.mark.parametrize("h, w, D, window, cost, census_window, uniqueness, g_row0, g_h, shift",
                         K1_EDGES)
def test_kernel_edges_match_plain_on_card(cuda, h, w, D, window, cost, census_window,
                                          uniqueness, g_row0, g_h, shift):
    """K1 bit-equal to its plain version where the main paths do not go: D
    from 1 to 200, w below D and below a tile, w not a multiple of the tile
    width, right-view winners one or two tiles away, census with 1-3
    planes, row shards with g_row0 < 0 and g_row0 + h > g_h."""
    rng = np.random.default_rng(D)
    left = rng.integers(0, 256, (h, w)).astype(np.float32)
    right = np.roll(left, -shift, axis=1) + rng.integers(0, 3, (h, w)).astype(np.float32)
    lg, rg = torch.as_tensor(left, device=cuda), torch.as_tensor(right, device=cuda)
    cfg = MatchConfig(num_disparities=D, window=window, cost=cost, census_window=census_window,
                      uniqueness=uniqueness, lr_threshold=None)
    got = fused_dense.raw_match(lg, rg, cfg, 16, g_row0, g_h)
    torch.cuda.synchronize()
    _outputs_equal(fused_dense.raw_match_plain(lg, rg, cfg, 16, g_row0, g_h), got)

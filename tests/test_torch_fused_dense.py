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

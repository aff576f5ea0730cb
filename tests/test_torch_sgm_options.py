"""``fused_sgm.match_pair_sgm_fused`` vs ``match_pair_sgm_pallas`` (interpret
mode) on its options: uniqueness, the unfused path for D > 128, the bf16
volume, an odd shape, float textures; and the errors it raises.

Rules: exactly equal on integer-valued gray inputs (see
``test_torch_sgm_pipeline.py``); bf16 too, since both packages round the
same sums once to bf16 in the same places (and only the unfused path rounds
the last one). On float textures the close rule, though the two add in the
same order."""

import dataclasses

import numpy as np
import pytest
import torch

from stepth_tpu.config import MatchConfig as RefMatchConfig
from stepth_tpu.match import pallas_sgm
from stepth_tpu.match import sgm as ref_sgm
from stepth_tpu_torch.config import MatchConfig, SGMConfig
from stepth_tpu_torch.match import fused_refine, fused_sgm

from tests.test_match_dense import make_pair
from tests.test_torch_sgm_pipeline import assert_results_equal, int_pair, run_both
from tests.torch_port import assert_close, np_, one_torch_thread  # noqa: F401 (autouse fixture)


def test_uniqueness_window_9(rng):
    left, right = int_pair(rng, h=48, w=96, shift=7)
    cfg = dict(num_disparities=32, window=9, lr_threshold=1.0, uniqueness=0.05)
    want, got = run_both(left, right, cfg, {})
    assert_results_equal(want, got)
    lr_only = fused_sgm.match_pair_sgm_plain(torch.from_numpy(left), torch.from_numpy(right),
                                             MatchConfig(**dict(cfg, uniqueness=None)))
    assert np_(got.valid).mean() < np_(lr_only.valid).mean()  # the test rejects pixels


def _spy_path(calls):
    def spy(*args, **kw):
        calls.append("scan_wta")
        return fused_sgm.scan_wta_direction(*args, **kw)

    return fused_refine.FUSED._replace(scan_wta=spy)


@pytest.mark.parametrize("D, fused", [(144, False), (128, True)])
def test_large_disparity_takes_the_unfused_path(rng, D, fused):
    """D > 128: K7 for every direction, then K9 — the reference's rule,
    kept so that bf16 outputs agree; D = 128 fuses the last scan (K8)."""
    left, right = int_pair(rng, h=24, w=176, shift=3)
    cfg = dict(num_disparities=D, window=3, lr_threshold=1.0)
    calls = []
    got = fused_sgm._match_pair_sgm(_spy_path(calls), left, right, MatchConfig(**cfg),
                                    SGMConfig(directions=4), "cpu")
    assert calls == (["scan_wta"] if fused else [])
    if not fused:
        want = pallas_sgm.match_pair_sgm_pallas(left, right, RefMatchConfig(**cfg),
                                                ref_sgm.SGMConfig(directions=4),
                                                interpret=True)
        assert_results_equal(want, got)


@pytest.mark.parametrize("directions", [4, 2])
def test_bf16_volume_exact(rng, directions):
    """``volume_dtype="bf16"``: K6 and every K7 store bf16, K8 sums in f32
    (4 directions); the unfused path (2 directions) reads bf16 sums in K9."""
    left, right = int_pair(rng, h=48, w=96, shift=6)
    cfg = dict(num_disparities=16, window=5, lr_threshold=1.0)
    want, got = run_both(left, right, cfg, dict(directions=directions, volume_dtype="bf16"))
    assert_results_equal(want, got)


def test_odd_shape(rng):
    left, right = int_pair(rng, h=37, w=61, shift=3)
    cfg = dict(num_disparities=16, window=5, lr_threshold=1.0)
    want, got = run_both(left, right, cfg, {})
    assert_results_equal(want, got)


def test_float_texture_close(rng):
    """A float texture: the close rule (an f32 box sum can round at a tie)."""
    left, right = make_pair(rng, h=48, w=96, shift=6)
    cfg = dict(num_disparities=16, window=5, lr_threshold=1.0)
    want, got = run_both(left, right, cfg, dict(directions=8))
    assert_close(np_(want.disparity), np_(want.valid), np_(got.disparity), np_(got.valid))
    assert abs(float(np.median(np_(got.disparity)[8:-8, 24:-8])) - 6) <= 0.5
    plain = fused_sgm.match_pair_sgm_plain(torch.from_numpy(left), torch.from_numpy(right),
                                           MatchConfig(**cfg), SGMConfig(directions=8))
    assert_results_equal(got, plain)


def test_errors():
    g = np.zeros((16, 32), np.float32)
    cfg = MatchConfig(num_disparities=8, window=5)
    with pytest.raises(ValueError, match="volume_dtype"):
        fused_sgm.match_pair_sgm_fused(g, g, cfg, SGMConfig(volume_dtype="f16"), device="cpu")
    with pytest.raises(ValueError, match="directions"):
        fused_sgm.match_pair_sgm_fused(g, g, cfg, SGMConfig(directions=6), device="cpu")
    with pytest.raises(NotImplementedError, match="cost"):
        fused_sgm.match_pair_sgm_fused(g, g, dataclasses.replace(cfg, cost="ncc"),
                                       device="cpu")
    with pytest.raises(ValueError, match="device"):
        fused_sgm.match_pair_sgm_fused(g, g, cfg)

"""``fused_sgm.match_pair_sgm_fused`` (the ``sgm-pallas`` backend; its plain
versions on the CPU) vs ``pallas_sgm.match_pair_sgm_pallas`` in interpret
mode, over the directions and the costs, and the ``sgm-pallas`` backend
through ``StereoModel``. The options are in ``test_torch_sgm_options.py``.

Rule: disparity, valid and cost exactly equal. The gray inputs are
integer-valued, so every cost, box sum and path sum is an exact f32 integer
below 2²⁴ (SSD is kept at window 5 with 4 directions for that) and no order
of adds can change a bit."""

import dataclasses

import numpy as np
import pytest
import torch

from stepth_tpu.config import MatchConfig as RefMatchConfig
from stepth_tpu.match import pallas_sgm
from stepth_tpu.match import sgm as ref_sgm
from stepth_tpu.models.stereo import StereoModel as RefStereoModel
from stepth_tpu_torch.config import MatchConfig, SGMConfig, from_dict
from stepth_tpu_torch.match import fused_sgm
from stepth_tpu_torch.models.stereo import StereoModel

from tests.torch_port import np_, one_torch_thread  # noqa: F401 (autouse fixture)


def int_pair(rng, h=40, w=72, shift=5):
    left = rng.integers(0, 256, (h, w)).astype(np.float32)
    return left, np.roll(left, -shift, axis=1)


def assert_results_equal(want, got):
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np_(b), np_(a))


def run_both(left, right, cfg: dict, sgm: dict):
    want = pallas_sgm.match_pair_sgm_pallas(left, right, RefMatchConfig(**cfg),
                                            ref_sgm.SGMConfig(**sgm), interpret=True)
    got = fused_sgm.match_pair_sgm_fused(left, right, MatchConfig(**cfg), SGMConfig(**sgm),
                                         device="cpu")
    return want, got


@pytest.mark.parametrize(
    "directions, cost",
    [(2, "sad"), (4, "sad"), (8, "sad"), (4, "ssd"), (4, "census")],
)
def test_matches_pallas(rng, directions, cost):
    """2 directions run K7 twice and K9 (+ K4); 4 and 8 run K7 for all but
    ↑y, then K8 (+ K4)."""
    left, right = int_pair(rng)
    cfg = dict(num_disparities=16, window=5, cost=cost, census_window=5, lr_threshold=1.0)
    sgm = dict(directions=directions, **(dict(p1=2.0, p2=8.0) if cost == "census" else {}))
    want, got = run_both(left, right, cfg, sgm)
    assert got.disparity.dtype == torch.float32 and got.disparity.shape == (40, 72)
    assert_results_equal(want, got)
    assert 0.5 < np_(got.valid).mean() < 1  # the LR check flags the wrapped band


def test_sgm_pallas_backend_matches_reference(rng):
    """``StereoModel(backend="sgm-pallas")`` from the reference's model."""
    left, right = int_pair(rng, h=32, w=64, shift=4)
    ref = RefStereoModel(backend="sgm-pallas",
                         match=RefMatchConfig(num_disparities=16, window=5, uniqueness=0.1),
                         sgm=ref_sgm.SGMConfig(directions=8, p1=4.0, p2=20.0))
    model = from_dict(StereoModel, dataclasses.asdict(ref))
    want = pallas_sgm.match_pair_sgm_pallas(left, right, ref.match, ref.sgm, interpret=True)
    assert_results_equal(want, model(left, right, device="cpu"))


def test_stored_path_past_256_matches_xla_sgm(rng):
    """8 directions at D = 290, past K7's tiles up to 256 (the deep tiling
    on the card): every direction stored, then K9 and K4, equal to the
    JAX package's XLA ``match_pair_sgm`` (the interpret-mode Pallas twin
    takes half a minute at this D)."""
    left, right = int_pair(rng, h=8, w=320, shift=270)
    cfg = dict(num_disparities=290, window=5, cost="census", census_window=7,
               lr_threshold=1.0)
    want = ref_sgm.match_pair_sgm(left, right, RefMatchConfig(**cfg),
                                  ref_sgm.SGMConfig(directions=8))
    got = fused_sgm.match_pair_sgm_fused(left, right, MatchConfig(**cfg),
                                         SGMConfig(directions=8), device="cpu")
    assert_results_equal(want, got)
    assert (np_(got.disparity) > 256).any()

"""``StereoModel(backend="hierarchical-sgm")``'s ``video()`` and ``batched()``
vs the JAX package's (Pallas in interpret mode).

Rule: every frame's disparity, valid and cost exactly equal: the clip is a
texture rounded to integers, so the SGM keyframes' costs and path sums are
exact f32 values, and the seeded frames run the same level-0 refine as on
``hierarchical-pallas``."""

import dataclasses

import numpy as np
import pytest
import torch

from stepth_tpu.config import MatchConfig as RefMatchConfig
from stepth_tpu.config import PyramidConfig as RefPyramidConfig
from stepth_tpu.models.stereo import StereoModel as RefStereoModel
from stepth_tpu_torch.config import from_dict
from stepth_tpu_torch.models.stereo import StereoModel

from tests.test_temporal_video import _clip
from tests.test_torch_hierarchical_sgm import REF_PRODUCTION, assert_results_equal, int_pair
from tests.torch_port import np_, one_torch_thread  # noqa: F401 (autouse fixture)


def test_video_matches_reference():
    """``video(keyframe_interval=2)`` on a 3-frame census clip with
    ``lr_check`` drifting 1 px per frame: frames 0 and 2 run the SGM
    pyramid, frame 1 the level-0 refine seeded by frame 0."""
    shifts = [5, 6, 7]
    lefts, rights = (np.round(a).astype(np.float32) for a in _clip(shifts))
    ref = RefStereoModel(backend="hierarchical-sgm",
                         match=RefMatchConfig(num_disparities=16, window=9, cost="census"),
                         pyramid=RefPyramidConfig(levels=2, refine_radius=4,
                                                  coarsest_disparities=8),
                         lr_check=True)
    model = from_dict(StereoModel, dataclasses.asdict(ref))
    want = ref.video(keyframe_interval=2)(lefts, rights)
    got = model.video(keyframe_interval=2)(lefts, rights, device="cpu")
    assert got.disparity.shape == (3, 64, 160)
    assert_results_equal(want, got)
    for t, s in enumerate(shifts):
        assert abs(float(np.median(np_(got.disparity[t])[8:-8, 24:-8])) - s) <= 0.75


def test_batched_matches_reference(rng):
    left, right = int_pair(rng)
    lefts, rights = np.stack([left, right]), np.stack([right, left])
    want = REF_PRODUCTION.batched()(lefts, rights)
    model = from_dict(StereoModel, dataclasses.asdict(REF_PRODUCTION))
    got = model.batched()(torch.from_numpy(lefts), torch.from_numpy(rights))
    assert got.disparity.shape == (2, 96, 256)
    assert_results_equal(want, got)


def test_video_backends():
    with pytest.raises(NotImplementedError, match="hierarchical"):
        StereoModel(backend="sgm-pallas").video()
    assert callable(StereoModel(backend="hierarchical-sgm").video(4))

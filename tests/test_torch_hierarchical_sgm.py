"""``hierarchical-sgm``: the coarse-to-fine pyramid with the SGM matcher at
its coarsest level (``fused_refine.match_hierarchical_fused(coarse_backend=
"sgm")``, ``StereoModel(backend="hierarchical-sgm")``) vs the JAX package's
``match_hierarchical_pallas(coarse_backend="sgm")`` in interpret mode, for
the SAD configuration and for production (census, ``lr_check=True``).
``video()`` and ``batched()`` are in ``test_torch_sgm_video.py``.

Rule: disparity, valid and cost exactly equal. The gray inputs are
integer-valued (a rounded smooth texture), so the coarse SGM's costs and
path sums are exact f32 values (dyadic after the downsamples) in any order
of adds, and the refine levels add in the reference's order."""

import dataclasses

import numpy as np
import pytest
import torch

from stepth_tpu.config import MatchConfig as RefMatchConfig
from stepth_tpu.config import PyramidConfig as RefPyramidConfig
from stepth_tpu.match import sgm as ref_sgm
from stepth_tpu.models.stereo import StereoModel as RefStereoModel
from stepth_tpu_torch.config import SGMConfig, from_dict
from stepth_tpu_torch.match import fused_refine
from stepth_tpu_torch.models.stereo import StereoModel

from tests.test_match_dense import make_pair
from tests.torch_port import cuda, np_, one_torch_thread  # noqa: F401 (fixtures)

REF_SAD = RefStereoModel(
    backend="hierarchical-sgm",
    match=RefMatchConfig(num_disparities=32, window=9, cost="sad"),
    pyramid=RefPyramidConfig(levels=3, coarsest_disparities=8),
    sgm=ref_sgm.SGMConfig(directions=4),
)
REF_PRODUCTION = dataclasses.replace(
    REF_SAD, match=RefMatchConfig(num_disparities=32, window=9, cost="census"), lr_check=True,
)


def int_pair(rng, h=96, w=256, shift=10):
    """A smooth texture rounded to integers, right = left shifted."""
    left, right = make_pair(rng, h=h, w=w, shift=shift)
    return np.round(left).astype(np.float32), np.round(right).astype(np.float32)


def assert_results_equal(want, got):
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np_(b), np_(a))


@pytest.mark.parametrize("ref", [REF_SAD, REF_PRODUCTION], ids=["sad", "production"])
def test_matches_reference(rng, ref):
    """The model and ``match_hierarchical_fused(coarse_backend="sgm")``:
    K6, 3 × K7, K8, K5 and K3 at the coarse level (plain versions here),
    then K2 at each finer level and the epilogue."""
    left, right = int_pair(rng)
    want = ref(left, right)
    model = from_dict(StereoModel, dataclasses.asdict(ref))
    got = model(left, right, device="cpu")
    assert got.disparity.shape == (96, 256)
    assert_results_equal(want, got)
    assert_results_equal(got, fused_refine.match_hierarchical_fused(
        torch.from_numpy(left), torch.from_numpy(right), model.match, model.pyramid,
        lr_check=model.lr_check, coarse_backend="sgm", sgm=model.sgm))
    assert abs(float(np.median(np_(got.disparity)[16:-16, 16:-16])) - 10) <= 0.5
    if ref.lr_check:
        assert 0.7 < np_(got.valid).mean() < 1


def test_default_sgm_config_and_bad_coarse_backend(rng):
    """``sgm=None`` means ``SGMConfig()``; an unknown coarse backend raises."""
    left, right = (torch.from_numpy(a) for a in int_pair(rng, 32, 128, 4))
    base = from_dict(StereoModel, dataclasses.asdict(REF_SAD))
    model = StereoModel(backend="hierarchical-sgm", match=base.match, pyramid=base.pyramid)
    assert model.sgm == SGMConfig()
    assert_results_equal(model(left, right), fused_refine.match_hierarchical_plain(
        left, right, model.match, model.pyramid, coarse_backend="sgm"))
    with pytest.raises(ValueError, match="coarse_backend"):
        fused_refine.match_hierarchical_fused(left, right, model.match, model.pyramid,
                                              coarse_backend="census")


@pytest.mark.cuda
@pytest.mark.parametrize("ref", [REF_SAD, REF_PRODUCTION], ids=["sad", "production"])
def test_kernel_path_matches_plain_on_card(cuda, rng, ref):
    left, right = (torch.from_numpy(a).to(cuda) for a in int_pair(rng))
    model = from_dict(StereoModel, dataclasses.asdict(ref))
    got = model(left, right)
    want = fused_refine.match_hierarchical_plain(left, right, model.match, model.pyramid,
                                                 lr_check=model.lr_check,
                                                 coarse_backend="sgm", sgm=model.sgm)
    torch.cuda.synchronize()
    assert got.disparity.is_cuda
    assert_results_equal(want, got)

"""The slice end to end: the port's ``StereoModel(backend="hierarchical-pallas")``
vs the reference's (Pallas in interpret mode), on a shifted pair and on the
``box`` edge scene; the port's ``scenes`` copy vs the reference's."""

import dataclasses

import numpy as np
import pytest
import torch

from stepth_tpu.config import MatchConfig as RefMatchConfig
from stepth_tpu.config import PyramidConfig as RefPyramidConfig
from stepth_tpu.models.stereo import StereoModel as RefStereoModel
from stepth_tpu.utils import scenes as ref_scenes
from stepth_tpu_torch.config import from_dict
from stepth_tpu_torch.match import fused_refine
from stepth_tpu_torch.models.stereo import StereoModel
from stepth_tpu_torch.utils import scenes

from tests.test_match_dense import make_pair
from tests.torch_port import assert_close, cuda, np_  # noqa: F401 (fixture)

REF_MODEL = RefStereoModel(
    backend="hierarchical-pallas",
    match=RefMatchConfig(num_disparities=32, window=9, cost="sad"),
    pyramid=RefPyramidConfig(levels=3, coarsest_disparities=8),
)
MODEL = from_dict(StereoModel, dataclasses.asdict(REF_MODEL))


def _pair(rng, name):
    if name == "shifted":
        left, right = make_pair(rng, h=96, w=256, shift=10)
        return left.astype(np.float32), right.astype(np.float32)
    sc = scenes.make_scene("box", 96, 256, 32, seed=1)
    return sc.left, sc.right


@pytest.mark.parametrize("name", ["shifted", "box"])
def test_model_matches_reference(rng, name):
    left, right = _pair(rng, name)
    want = REF_MODEL(left, right)
    got = MODEL(left, right, device="cpu")
    assert got.disparity.shape == (96, 256) and got.disparity.dtype == torch.float32
    assert torch.isfinite(got.disparity).all()
    assert_close(np_(want.disparity), np_(want.valid), np_(got.disparity), np_(got.valid))
    if name == "shifted":
        assert abs(float(np.median(np_(got.disparity)[16:-16, 16:-16])) - 10) <= 0.5
    np.testing.assert_array_equal(
        np_(MODEL.depth_u8(torch.from_numpy(left), torch.from_numpy(right))),
        np_(REF_MODEL.depth_u8(left, right)),
    )


def test_rgb_input_matches_reference(rng):
    left, right = make_pair(rng, h=64, w=160, shift=6)
    rgb_l = np.stack([left, left * 0.9, left * 0.5], -1).astype(np.uint8)
    rgb_r = np.stack([right, right * 0.9, right * 0.5], -1).astype(np.uint8)
    want = REF_MODEL(rgb_l, rgb_r)
    got = MODEL(rgb_l, rgb_r, device="cpu")
    assert_close(np_(want.disparity), np_(want.valid), np_(got.disparity), np_(got.valid))


@pytest.mark.parametrize("name", ["box", "slant", "photometric", "ellipses"])
def test_scenes_copy_equals_reference(name):
    got = scenes.make_scene(name, 48, 160, 32, seed=1)
    want = ref_scenes.make_scene(name, 48, 160, 32, seed=1)
    for field in ("left", "right", "disparity", "occluded", "edges"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))


@pytest.mark.parametrize(
    "backend", ["dense", "pallas", "hierarchical", "hierarchical-sgm", "sgm", "sgm-pallas",
                "parity"],
)
def test_unported_backends_name_their_roadmap_item(backend):
    g = torch.zeros((32, 128))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        StereoModel(backend=backend)(g, g)


def test_unknown_backend_and_lr_check_raise():
    g = torch.zeros((32, 128))
    with pytest.raises(ValueError, match="unknown backend"):
        StereoModel(backend="nope")(g, g)
    with pytest.raises(NotImplementedError, match="slice 2"):
        dataclasses.replace(MODEL, lr_check=True)(g, g)
    with pytest.raises(ValueError, match="device"):
        MODEL(np.zeros((32, 128)), np.zeros((32, 128)))


@pytest.mark.cuda
def test_kernel_path_matches_plain_on_card(cuda, rng):
    left, right = _pair(rng, "box")
    lt, rt = torch.from_numpy(left).to(cuda), torch.from_numpy(right).to(cuda)
    got = MODEL(lt, rt)
    want = fused_refine.match_hierarchical_plain(lt, rt, MODEL.match, MODEL.pyramid)
    torch.cuda.synchronize()
    assert got.disparity.is_cuda
    assert_close(np_(want.disparity), np_(want.valid), np_(got.disparity), np_(got.valid))

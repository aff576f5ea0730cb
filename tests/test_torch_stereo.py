"""The slices end to end through ``StereoModel`` vs the reference's (Pallas
in interpret mode), on a shifted pair and on the ``box`` edge scene: the SAD
hierarchical slice by the "close" rule; the production configuration
(census, ``lr_check=True``), ``flagship()`` (the ``pallas`` backend),
``video()`` and ``batched()`` exactly (disparity and ``valid``); the
``dense`` backend by the "close" rule (cumulative-sum box sums). Also the
port's ``scenes`` copy vs the reference's."""

import dataclasses

import numpy as np
import pytest
import torch

from stepth_tpu.config import MatchConfig as RefMatchConfig
from stepth_tpu.config import PyramidConfig as RefPyramidConfig
from stepth_tpu.models.stereo import StereoModel as RefStereoModel
from stepth_tpu.models.stereo import flagship as ref_flagship
from stepth_tpu.utils import scenes as ref_scenes
from stepth_tpu_torch.config import from_dict
from stepth_tpu_torch.match import fused_refine
from stepth_tpu_torch.models.stereo import StereoModel, flagship
from stepth_tpu_torch.utils import scenes

from tests.test_match_dense import make_pair
from tests.test_temporal_video import _clip
from tests.torch_port import assert_close, cuda, np_, one_torch_thread  # noqa: F401 (fixtures)

REF_MODEL = RefStereoModel(
    backend="hierarchical-pallas",
    match=RefMatchConfig(num_disparities=32, window=9, cost="sad"),
    pyramid=RefPyramidConfig(levels=3, coarsest_disparities=8),
)
MODEL = from_dict(StereoModel, dataclasses.asdict(REF_MODEL))
REF_PRODUCTION = dataclasses.replace(
    REF_MODEL, match=RefMatchConfig(num_disparities=32, window=9, cost="census"),
    lr_check=True,
)
PRODUCTION = from_dict(StereoModel, dataclasses.asdict(REF_PRODUCTION))


def _equal(want, got):
    """MatchResult fields exactly equal."""
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np_(b), np_(a))


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


@pytest.mark.parametrize("census_window", [5, 7])
@pytest.mark.parametrize("name", ["shifted", "box"])
def test_production_matches_reference(rng, name, census_window):
    """Census + ``lr_check=True``: K1 and K2 on census planes, K2's right
    view at level 0, then K4, K5 and K3 — disparity and ``valid`` exact."""
    left, right = _pair(rng, name)
    m = dataclasses.replace(REF_PRODUCTION.match, census_window=census_window)
    want = dataclasses.replace(REF_PRODUCTION, match=m)(left, right)
    got = from_dict(StereoModel, dataclasses.asdict(dataclasses.replace(
        REF_PRODUCTION, match=m)))(left, right, device="cpu")
    _equal(want, got)
    valid = np_(got.valid)
    assert 0.7 < valid.mean() < 1  # the LR check flags occlusions, keeps the rest
    if name == "shifted":
        assert abs(float(np.median(np_(got.disparity)[16:-16, 16:-16])) - 10) <= 0.5


@pytest.mark.parametrize("backend", ["pallas", "dense"])
def test_flagship_and_dense_backends_match_reference(rng, backend):
    """``flagship()`` is the ``pallas`` backend (SAD, D=32 here, LR check):
    exact. The ``dense`` backend by the "close" rule."""
    left, right = make_pair(rng, h=48, w=160, shift=6)
    want_model, got_model = ref_flagship(32), flagship(32)
    assert got_model.backend == "pallas"
    if backend == "dense":
        want_model = dataclasses.replace(want_model, backend="dense")
        got_model = dataclasses.replace(got_model, backend="dense")
    want = want_model(left, right)
    got = got_model(torch.from_numpy(left), torch.from_numpy(right))
    if backend == "pallas":
        _equal(want, got)
    else:
        assert_close(np_(want.disparity), np_(want.valid), np_(got.disparity), np_(got.valid))
    assert abs(float(np.median(np_(got.disparity)[8:-8, 40:-8])) - 6) <= 0.5


@pytest.mark.parametrize("lr_check", [False, True])
def test_video_matches_reference(lr_check):
    """``video(keyframe_interval=2)`` on a 4-frame census clip drifting 1 px
    per frame: keyframes run the pyramid, seeded frames level 0 only."""
    shifts = [5, 6, 7, 8]
    lefts, rights = _clip(shifts)
    ref = RefStereoModel(backend="hierarchical-pallas",
                         match=RefMatchConfig(num_disparities=16, window=9, cost="census"),
                         pyramid=RefPyramidConfig(levels=2, refine_radius=4,
                                                  coarsest_disparities=8),
                         lr_check=lr_check)
    model = from_dict(StereoModel, dataclasses.asdict(ref))
    want = ref.video(keyframe_interval=2)(lefts, rights)
    got = model.video(keyframe_interval=2)(lefts, rights, device="cpu")
    assert got.disparity.shape == (4, 64, 160)
    _equal(want, got)
    for t, s in enumerate(shifts):
        assert abs(float(np.median(np_(got.disparity[t])[8:-8, 24:-8])) - s) <= 0.75


def test_batched_matches_reference(rng):
    left, right = _pair(rng, "shifted")
    lefts, rights = np.stack([left, right]), np.stack([right, left])
    want = REF_PRODUCTION.batched()(lefts, rights)
    got = PRODUCTION.batched()(torch.from_numpy(lefts), torch.from_numpy(rights))
    assert got.disparity.shape == (2, 96, 256)
    _equal(want, got)


@pytest.mark.parametrize("backend", ["hierarchical", "parity"])
def test_unported_backends_name_their_roadmap_item(backend):
    """The two backends ported last run on the tensors' device, and arrays
    with no device named go to the card: without one they raise."""
    g = torch.zeros((32, 128, 3), dtype=torch.uint8)
    res = StereoModel(backend=backend)(g, g)
    assert res.disparity.shape == (32, 128) and res.disparity.device == g.device
    assert bool(torch.isfinite(res.disparity).all())
    if backend == "parity":  # all pixels match at distance 0
        assert bool(res.valid.all()) and not bool(res.disparity.any())
    with pytest.raises(ValueError, match="device"):
        StereoModel(backend=backend)(np_(g), np_(g))


def test_unknown_backend_and_lr_check_raise():
    g = torch.zeros((32, 128))
    with pytest.raises(ValueError, match="unknown backend"):
        StereoModel(backend="nope")(g, g)
    with pytest.raises(ValueError, match="refine level"):
        dataclasses.replace(PRODUCTION, pyramid=dataclasses.replace(
            PRODUCTION.pyramid, levels=1))(g, g)
    with pytest.raises(ValueError, match="device"):
        MODEL(np.zeros((32, 128)), np.zeros((32, 128)))
    with pytest.raises(NotImplementedError, match="hierarchical"):
        StereoModel(backend="dense").video()


@pytest.mark.cuda
def test_kernel_path_matches_plain_on_card(cuda, rng):
    left, right = _pair(rng, "box")
    lt, rt = torch.from_numpy(left).to(cuda), torch.from_numpy(right).to(cuda)
    got = MODEL(lt, rt)
    want = fused_refine.match_hierarchical_plain(lt, rt, MODEL.match, MODEL.pyramid)
    torch.cuda.synchronize()
    assert got.disparity.is_cuda
    assert_close(np_(want.disparity), np_(want.valid), np_(got.disparity), np_(got.valid))


@pytest.mark.cuda
def test_production_kernel_path_matches_plain_on_card(cuda, rng):
    left, right = _pair(rng, "box")
    lt, rt = torch.from_numpy(left).to(cuda), torch.from_numpy(right).to(cuda)
    got = PRODUCTION(lt, rt)
    want = fused_refine.match_hierarchical_plain(lt, rt, PRODUCTION.match, PRODUCTION.pyramid,
                                                 lr_check=True)
    torch.cuda.synchronize()
    _equal(want, got)

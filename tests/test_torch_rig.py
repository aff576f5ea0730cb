"""The calibrated-rig slice end to end at 96×256, as ``tests/test_rectify.py``'s
rectify → match → depth flow, with lens distortion in both cameras and a
darker right view:

1. the JAX package's maps carried across (``maps_from_arrays``) rectify the
   pair as the JAX package does, within 1e-3 (its f32 gather contracts
   products into FMAs, so a few ulps apart);
2. both packages' production ``StereoModel`` (census, ``lr_check``) agree on
   that rectified pair by the close rule;
3. the port's own chain (its maps, gain match, K11's plain version,
   production, ``disparity_to_depth``, ``depth_to_points``, ``save_ply``)
   recovers the analytic disparity f·B/Z_rect within 0.5 px (median over
   an interior crop) and the metric depth within 2%; the depth utilities
   on its output equal the JAX package's.
"""

import numpy as np
import pytest
import torch

from stepth_tpu.config import MatchConfig as RefMatchConfig
from stepth_tpu.config import PyramidConfig as RefPyramidConfig
from stepth_tpu.models.stereo import StereoModel as RefStereoModel
from stepth_tpu.ops import depth as ref_depth
from stepth_tpu.ops import kmeans as ref_kmeans
from stepth_tpu.ops import rectify as ref_rectify
from stepth_tpu_torch.config import MatchConfig, PyramidConfig
from stepth_tpu_torch.core import io
from stepth_tpu_torch.fusion import geometry
from stepth_tpu_torch.match import dense, fused_refine
from stepth_tpu_torch.models.stereo import StereoModel
from stepth_tpu_torch.ops import depth, fused_remap, kmeans, photometric, rectify
from stepth_tpu_torch.utils.rig import plane_rig

from tests.torch_port import assert_close, cuda, np_, one_torch_thread  # noqa: F401 (fixtures)

H, W = 96, 256
K = np.array([[220.0, 0, 127.5], [0, 220.0, 47.5], [0, 0, 1]], np.float32)
T = np.array([-0.5, 0.01, 0.005], np.float32)  # f·B/Z = 22 px at Z = 5
DIST1 = (-0.05, 0.01, 0.0005, -0.0003)
DIST2 = (-0.04, 0.008, -0.0004, 0.0002)
CROP = (slice(16, -16), slice(40, -40))  # clear of the fill the rotation leaves


def _rot(axis, deg):
    a = np.deg2rad(deg)
    c, s = np.cos(a), np.sin(a)
    if axis == "x":
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


R = (_rot("y", 2.0) @ _rot("x", -0.5)).astype(np.float32)
REF_PRODUCTION = RefStereoModel(
    backend="hierarchical-pallas",
    match=RefMatchConfig(num_disparities=32, window=9, cost="census"),
    pyramid=RefPyramidConfig(levels=3, coarsest_disparities=8), lr_check=True)
PRODUCTION = StereoModel(
    backend="hierarchical-pallas",
    match=MatchConfig(num_disparities=32, window=9, cost="census"),
    pyramid=PyramidConfig(levels=3, coarsest_disparities=8), lr_check=True)


@pytest.fixture(scope="module")
def scene():
    return plane_rig(H, W, K, R, T, DIST1, DIST2, depth=5.0, right_gain=0.85, seed=3)


@pytest.fixture(scope="module")
def ref_rectified(scene):
    """The JAX package's maps and its rectified pair (its default backend)."""
    ref_maps = ref_rectify.rectify_maps(K, K, R, T, (H, W), dist1=DIST1, dist2=DIST2)
    return ref_maps, ref_rectify.rectify_pair(scene.left, scene.right, ref_maps)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_carried_maps_rectify_as_reference(scene, ref_rectified, backend):
    ref_maps, want = ref_rectified
    maps = rectify.maps_from_arrays(*(np.asarray(f) for f in ref_maps), device="cpu")
    got = rectify.rectify_pair(scene.left, scene.right, maps, backend=backend)
    for g, r in zip(got, want):
        assert g.shape == (H, W, 3) and g.dtype == torch.float32
        np.testing.assert_allclose(np_(g), np_(r), rtol=0, atol=1e-3)


def test_production_models_agree_on_rectified_pair(ref_rectified):
    left, right = (np.array(v) for v in ref_rectified[1])
    ref = REF_PRODUCTION(left, right)
    res = PRODUCTION(left, right, device="cpu")
    assert_close(np_(ref.disparity), np_(ref.valid), np_(res.disparity), np_(res.valid))


def test_port_chain_recovers_analytic_depth(scene, tmp_path):
    maps = rectify.rectify_maps(K, K, R, T, (H, W), dist1=DIST1, dist2=DIST2, device="cpu")
    right = photometric.normalize_brightness_f32(scene.right, scene.left, device="cpu")
    assert right.dtype == torch.uint8
    lr, rr = rectify.rectify_pair(scene.left, right, maps, backend="pallas")
    res = PRODUCTION(lr, rr)
    disp = np_(res.disparity)
    assert np.isfinite(disp).all() and 0.8 < np_(res.valid).mean() < 1
    want = float(np.median(scene.disparity[CROP]))
    assert abs(float(np.median(disp[CROP])) - want) <= 0.5, (np.median(disp[CROP]), want)

    z = geometry.disparity_to_depth(res.disparity, maps.focal, maps.baseline)
    z_want = float(np.median(scene.z_rect[CROP]))
    assert abs(float(np.median(np_(z)[CROP])) / z_want - 1) <= 0.02
    fx = float(maps.K_new[0, 0])
    intr = torch.tensor([fx, float(maps.K_new[1, 1]), float(maps.K_new[0, 2]),
                         float(maps.K_new[1, 2])])
    pts = geometry.depth_to_points(z, intr)
    keep = res.valid & torch.isfinite(pts).all(-1)
    n = io.save_ply(tmp_path / "rig.ply", pts, colors=lr, valid=res.valid)
    assert n == int(keep.sum()) > 0
    assert f"element vertex {n}\n".encode() in (tmp_path / "rig.ply").read_bytes()[:200]

    # the depth utilities users apply to the output
    d8 = dense.disparity_to_depth_u8(res.disparity, PRODUCTION.match.num_disparities)
    zones = kmeans.depth_split(d8, 3)
    assert zones == ref_kmeans.depth_split(np_(d8), 3)
    for lo, hi in zones:
        np.testing.assert_array_equal(np_(depth.slice_mask(d8, lo, hi)),
                                      np_(ref_depth.slice_mask(np_(d8), lo, hi)))


@pytest.mark.cuda
def test_rig_kernel_path_equals_plain_path_on_card(cuda, scene):
    """K11 (both views) then production on the card, against the plain
    versions of every kernel on the same card: bit-equal."""
    maps = rectify.rectify_maps(K, K, R, T, (H, W), dist1=DIST1, dist2=DIST2, device=cuda)
    right = photometric.normalize_brightness_f32(scene.right, scene.left, device=cuda)
    before = fused_remap.K11.launches
    lr, rr = rectify.rectify_pair(scene.left, right, maps, backend="pallas")
    res = PRODUCTION(lr, rr)
    torch.cuda.synchronize()
    assert fused_remap.K11.launches == before + 2
    left = torch.as_tensor(scene.left, device=cuda).float()
    plr = fused_remap.remap_bilinear_plain(left, maps.map_left)
    prr = fused_remap.remap_bilinear_plain(right.float(), maps.map_right)
    assert torch.equal(lr, plr) and torch.equal(rr, prr)
    plain = fused_refine.match_hierarchical_plain(plr, prr, PRODUCTION.match,
                                                  PRODUCTION.pyramid, lr_check=True)
    assert torch.equal(res.disparity, plain.disparity) and torch.equal(res.valid, plain.valid)

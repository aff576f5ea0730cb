"""The port's two-view geometry (``fusion.epipolar``) against the JAX
package's.

Singular vectors carry an arbitrary sign, so ``E`` is compared after
normalising sign and scale, and R, T after the cheirality test; both
within 1e-4 (points within 1e-4 of their scale). RANSAC draws its samples
from a seeded ``torch.Generator``; the reference draws them from JAX's
threefry, which torch cannot reproduce, so the consensus sets (and the
poses refined on them) differ draw by draw. The deterministic paths
(``ransac_iters=0``) agree within 1e-3; on the reference's integration
scene both stay within that test's bounds, and where the inlier masks
agree, R and T agree within 1e-3."""

import sys

import jax.numpy as jnp
import numpy as np
import torch

from stepth_tpu.config import MatchConfig as RefMatchConfig
from stepth_tpu.config import PyramidConfig as RefPyramidConfig
from stepth_tpu.fusion import epipolar as ref_epipolar
from stepth_tpu.fusion import geometry as ref_geo
from stepth_tpu.match import features as ref_features
from stepth_tpu.models.stereo import StereoModel as RefStereoModel
from stepth_tpu.ops import rectify as ref_rectify
from stepth_tpu_torch.fusion import epipolar
from stepth_tpu_torch.match import features

from tests.test_epipolar import _rig
from tests.test_rectify import K, _rot
from tests.torch_port import np_, one_torch_thread  # noqa: F401 (autouse fixture)


def _unit(E):
    E = np_(E).astype(np.float64)
    E = E / np.linalg.norm(E)
    return E * np.sign(E.flat[np.argmax(np.abs(E))])


def test_essential_matches_reference(rng):
    R, T, _, x1, x2 = _rig(rng)
    want = ref_epipolar.estimate_essential(jnp.asarray(x1), jnp.asarray(x2))
    got = epipolar.estimate_essential(torch.from_numpy(x1), torch.from_numpy(x2))
    np.testing.assert_allclose(_unit(got), _unit(want), atol=1e-4)
    Tx = np.array([[0, -T[2], T[1]], [T[2], 0, -T[0]], [-T[1], T[0], 0]], np.float32)
    np.testing.assert_allclose(_unit(got), _unit(Tx @ R), atol=1e-4)
    # a batch of problems equals each problem alone
    batch = epipolar.estimate_essential(torch.from_numpy(np.stack([x1[:40], x1[40:80]])),
                                        torch.from_numpy(np.stack([x2[:40], x2[40:80]])))
    for i, sl in enumerate((slice(0, 40), slice(40, 80))):
        one = epipolar.estimate_essential(torch.from_numpy(x1[sl]), torch.from_numpy(x2[sl]))
        np.testing.assert_allclose(_unit(batch[i]), _unit(one), atol=1e-5)
    np.testing.assert_allclose(
        np_(epipolar.epipolar_residuals(got, torch.from_numpy(x1), torch.from_numpy(x2))),
        np_(ref_epipolar.epipolar_residuals(want, jnp.asarray(x1), jnp.asarray(x2))),
        atol=1e-5)


def test_recover_pose_and_triangulate_match_reference(rng):
    R, T, pts, x1, x2 = _rig(rng)
    E = np_(ref_epipolar.estimate_essential(jnp.asarray(x1), jnp.asarray(x2)))
    Rw, Tw, Xw = ref_epipolar.recover_pose(jnp.asarray(E), jnp.asarray(x1), jnp.asarray(x2))
    Rg, Tg, Xg = epipolar.recover_pose(torch.from_numpy(E.copy()), torch.from_numpy(x1),
                                       torch.from_numpy(x2))
    np.testing.assert_allclose(np_(Rg), np_(Rw), atol=1e-4)
    np.testing.assert_allclose(np_(Tg), np_(Tw), atol=1e-4)
    np.testing.assert_allclose(np_(Xg), np_(Xw), atol=1e-4 * np.abs(np_(Xw)).max())
    np.testing.assert_allclose(np_(Rg), R, atol=1e-4)
    Xt = epipolar.triangulate(R, T, torch.from_numpy(x1), torch.from_numpy(x2))
    np.testing.assert_allclose(np_(Xt), np_(ref_epipolar.triangulate(R, T, jnp.asarray(x1),
                                                                     jnp.asarray(x2))),
                               atol=1e-4 * np.abs(pts).max())
    np.testing.assert_allclose(np_(Xt), pts, rtol=2e-3, atol=2e-3)


def test_ransac_rejects_planted_outliers(rng):
    _, _, _, x1, x2 = _rig(rng, n=120)
    x2 = x2.copy()
    bad = rng.choice(120, size=15, replace=False)
    x2[bad] += rng.uniform(0.02, 0.05, (15, 2)).astype(np.float32)
    E, mask = epipolar.ransac_essential(torch.from_numpy(x1), torch.from_numpy(x2), iters=64,
                                        thresh=1e-3, seed=3)
    mask = np_(mask)
    assert not mask[bad].any() and mask.sum() >= 100
    E2, mask2 = epipolar.ransac_essential(torch.from_numpy(x1), torch.from_numpy(x2),
                                          iters=64, thresh=1e-3, seed=3)
    assert torch.equal(E, E2) and (np_(mask2) == mask).all()  # the seed fixes the draw


def _integration_scene():
    """tests/test_features.py::test_images_to_pose_integration's views."""
    h, w = 128, 192
    R = _rot("y", 3.0).astype(np.float32)
    T = np.array([-0.5, 0.0, 0.0], np.float32)

    def zsurf(xw, yw):
        return 5.0 + 1.2 * np.sin(1.3 * xw) + 0.9 * np.cos(1.1 * yw)

    def tex(xw, yw):
        v = 120 + 60 * np.sin(7.1 * xw) + 50 * np.cos(5.3 * yw)
        v += 25 * np.sin(13.7 * xw + 11.9 * yw) + 15 * np.cos(23.0 * xw * yw)
        return v

    def render(rays, origin):
        s = (5.0 - origin[2]) / rays[..., 2]
        for _ in range(50):
            X = origin + s[..., None] * rays
            s = (zsurf(X[..., 0], X[..., 1]) - origin[2]) / rays[..., 2]
        X = origin + s[..., None] * rays
        return tex(X[..., 0], X[..., 1]).astype(np.float32)

    xx, yy = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    rays1 = np.einsum("ij,hwj->hwi", np.linalg.inv(K),
                      np.stack([xx, yy, np.ones_like(xx)], -1))
    return (render(rays1, np.zeros(3, np.float32)),
            render(np.einsum("ji,hwj->hwi", R, rays1), -R.T @ T), R, T)


def test_pose_from_correspondences_integration_scene():
    left, right, R, T = _integration_scene()
    uv1, uv2 = features.match_pair_features(left, right, max_corners=512, min_similarity=0.8,
                                            device="cpu")
    assert uv1.shape[0] >= 40
    u1, u2 = np_(uv1), np_(uv2)
    t_unit = T / np.linalg.norm(T)
    # deterministic: the plain eight-point, alone and refined
    for refine in (False, True):
        want = ref_epipolar.pose_from_correspondences(u1, u2, K, K, ransac_iters=0,
                                                      refine=refine)
        got = epipolar.pose_from_correspondences(u1, u2, K, K, ransac_iters=0, refine=refine,
                                                 device="cpu")
        np.testing.assert_allclose(np_(got[0]), np_(want[0]), atol=1e-3)
        np.testing.assert_allclose(np_(got[1]), np_(want[1]), atol=1e-3)
    # the default RANSAC path: the reference's bounds (tests/test_features.py:96-100)
    R8, T8, _ = epipolar.pose_from_correspondences(u1, u2, K, K, refine=False, device="cpu")
    assert np.abs(np_(R8) - R).max() < 0.15 and float(np.dot(np_(T8), t_unit)) > 0.6
    Rb, Tb, _ = epipolar.pose_from_correspondences(u1, u2, K, K, device="cpu")
    assert np.abs(np_(Rb) - R).max() < 2e-2 and float(np.dot(np_(Tb), t_unit)) > 0.99
    # where the consensus sets agree, so do the poses
    x1 = (u1 - K[:2, 2]) / K[0, 0]
    x2 = (u2 - K[:2, 2]) / K[0, 0]
    thresh = 2.0 / K[0, 0]
    _, mask_w = ref_epipolar.ransac_essential(jnp.asarray(x1), jnp.asarray(x2), thresh=thresh)
    _, mask_g = epipolar.ransac_essential(torch.from_numpy(x1), torch.from_numpy(x2),
                                          thresh=thresh)
    if (np_(mask_w) == np_(mask_g)).all():
        Rw, Tw, _ = ref_epipolar.pose_from_correspondences(u1, u2, K, K)
        np.testing.assert_allclose(np_(Rb), np_(Rw), atol=1e-3)
        np.testing.assert_allclose(np_(Tb), np_(Tw), atol=1e-3)


def test_two_view_example_draws():
    """examples/two_view_reconstruction.py's flow over RANSAC seeds 0-9, as
    chip_smoke.py phase 7b runs it (the port on CPU tensors; the reference
    as the example runs on the CPU): the pose checks hold on every draw for
    both, and the dense-depth check on at least as many of the port's draws
    as of the reference's (``chip_smoke.TWO_VIEW_MIN_DEPTH_PASSES``). The
    example's own run: ``chip_smoke.TWO_VIEW_EXAMPLE_POSE`` is the
    reference's pose of draw 0, and through the port's rectification and
    dense match it passes the example's depth check."""
    sys.path.insert(0, __file__.rsplit("/tests/", 1)[0])
    import chip_smoke

    img1, img2, Kv, R_gt, T_gt, gt_median = chip_smoke.two_view_scene(*chip_smoke.TWO_VIEW_SHAPE)
    baseline = float(np.linalg.norm(T_gt))
    u1, u2 = ref_features.match_pair_features(img1, img2, max_corners=512, min_similarity=0.8)
    port_matches = features.match_pair_features(img1, img2, max_corners=512, min_similarity=0.8,
                                                device="cpu")
    model = RefStereoModel(backend="hierarchical",
                           match=RefMatchConfig(num_disparities=64, window=9, cost="sad"),
                           pyramid=RefPyramidConfig(levels=3, coarsest_disparities=16))

    def checks(R, t, med, K_new):
        R, t = np_(R), np_(t)
        ang = np.rad2deg(np.arccos(np.clip(np.dot(t, T_gt / baseline), -1.0, 1.0)))
        assert np.abs(R - R_gt).max() < 3e-2 and ang < 9.0
        return abs(med - gt_median(R, t * baseline, K_new)) < 0.4

    passes = {"ref": 0, "port": 0}
    for seed in range(chip_smoke.TWO_VIEW_SEEDS):
        R, t, _ = ref_epipolar.pose_from_correspondences(u1, u2, Kv, Kv, seed=seed)
        if seed == 0:
            np.testing.assert_allclose(np_(R), chip_smoke.TWO_VIEW_EXAMPLE_POSE[0], atol=1e-6)
            np.testing.assert_allclose(np_(t), chip_smoke.TWO_VIEW_EXAMPLE_POSE[1], atol=1e-6)
        maps = ref_rectify.rectify_maps(Kv, Kv, np_(R), np_(t) * baseline, img1.shape)
        rl, rr = ref_rectify.rectify_pair(jnp.asarray(img1), jnp.asarray(img2), maps)
        depth = ref_geo.disparity_to_depth(model(rl, rr).disparity, maps.focal, maps.baseline)
        passes["ref"] += checks(R, t, float(np.median(np_(depth)[24:-24, 32:-32])),
                                np_(maps.K_new))
        got = chip_smoke.two_view(img1, img2, Kv, torch.device("cpu"), "pallas", seed=seed,
                                  matches=port_matches)
        passes["port"] += checks(got["R"], got["t"], got["depth_median"], got["K_new"])
    assert passes["ref"] == chip_smoke.TWO_VIEW_MIN_DEPTH_PASSES, passes
    assert passes["port"] >= passes["ref"], passes
    ex = chip_smoke.two_view(img1, img2, Kv, torch.device("cpu"), "pallas",
                             pose=chip_smoke.TWO_VIEW_EXAMPLE_POSE)
    assert checks(ex["R"], ex["t"], ex["depth_median"], ex["K_new"])


def test_ransac_scores_equal_samples_alike():
    """The draw is the only difference: on the same 8-point samples the
    port's hypotheses count the same inliers as the reference's, on the
    two-view scene's matches."""
    sys.path.insert(0, __file__.rsplit("/tests/", 1)[0])
    import jax
    import chip_smoke

    img1, img2, Kv, _, _, _ = chip_smoke.two_view_scene(*chip_smoke.TWO_VIEW_SHAPE)
    u1, u2 = (np_(u) for u in features.match_pair_features(
        img1, img2, max_corners=512, min_similarity=0.8, device="cpu"))
    x1 = ((u1 - Kv[:2, 2]) / Kv[0, 0]).astype(np.float32)
    x2 = ((u2 - Kv[:2, 2]) / Kv[0, 0]).astype(np.float32)
    thresh = 2.0 / Kv[0, 0]
    gen = torch.Generator().manual_seed(0)
    idx = torch.rand(256, x1.shape[0], generator=gen).argsort(-1)[:, :8]
    t1, t2 = torch.from_numpy(x1), torch.from_numpy(x2)
    got = (epipolar.epipolar_residuals(epipolar.estimate_essential(t1[idx], t2[idx]), t1, t2)
           < thresh).sum(1)
    j1, j2 = jnp.asarray(x1), jnp.asarray(x2)
    Es = jax.vmap(lambda i: ref_epipolar.estimate_essential(j1[i], j2[i]))(jnp.asarray(idx.numpy()))
    want = (jax.vmap(lambda E: ref_epipolar.epipolar_residuals(E, j1, j2))(Es) < thresh).sum(1)
    np.testing.assert_array_equal(np_(got), np_(want))

"""Rectification: the port's ``ops.rectify`` against the JAX package's on the
rigs of ``tests/test_rectify.py`` and ``tests/test_pallas_remap.py`` (with
and without lens distortion).

Tolerances: maps within 1e-3 px, the reference's own (``test_rectify.py``;
both packages work in f32 and take the 3×3 products in other orders; the
largest difference measured on these rigs is 3.1e-5 px); focal and
baseline within 1e-6 relative (they came out equal); ``project_rectified``
within 1e-5 relative and ``distort_normalized`` within 1e-6 relative."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stepth_tpu.ops import rectify as ref_rectify
from stepth_tpu_torch.ops import rectify

from tests.torch_port import np_, one_torch_thread  # noqa: F401 (autouse fixture)


def _rot(axis, deg):
    a = np.deg2rad(deg)
    c, s = np.cos(a), np.sin(a)
    if axis == "x":
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)
    if axis == "y":
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)


K = np.array([[200.0, 0, 96.0], [0, 200.0, 64.0], [0, 0, 1.0]], np.float32)
K180 = np.array([[180.0, 0, 95.0], [0, 180.0, 47.0], [0, 0, 1]], np.float32)
RIGS = {
    # test_rectify.py: the identity rig, the rotated rig, the distorted rig
    "identity": dict(K1=K, K2=K, R=np.eye(3, dtype=np.float32),
                     T=np.array([-0.5, 0.0, 0.0], np.float32), image_shape=(128, 192)),
    "rotated": dict(K1=K, K2=K, R=(_rot("y", 3.0) @ _rot("x", -2.0) @ _rot("z", 1.5)),
                    T=np.array([-0.6, 0.04, 0.02], np.float32), image_shape=(128, 192)),
    "distorted": dict(K1=K, K2=K, R=_rot("y", 2.5), T=np.array([-0.5, 0.02, 0.0], np.float32),
                      image_shape=(128, 192),
                      dist1=np.array([-0.12, 0.03, 0.001, -0.0005], np.float32),
                      dist2=np.array([-0.08, 0.02, -0.0008, 0.0004], np.float32)),
    # test_pallas_remap.py::test_rectify_rig_maps
    "remap_rig": dict(K1=K180, K2=K180, R=_rot("y", np.rad2deg(0.04)),
                      T=np.array([-0.6, 0.02, 0.01], np.float32), image_shape=(96, 192),
                      dist1=(0.05, -0.01, 0.001, 0.0)),
    # a five-term lens, another right camera and an explicit K_new
    "k3_k_new": dict(K1=K, K2=K180 * np.array([[1.02], [1.02], [1]], np.float32),
                     R=_rot("x", 1.0) @ _rot("y", -1.5), T=np.array([-0.4, -0.01, 0.03], np.float32),
                     image_shape=(100, 180), K_new=K180,
                     dist1=(-0.1, 0.02, 0.0005, 0.0002, -0.004),
                     dist2=(-0.06, 0.01, 0.0, 0.0, 0.002)),
}


@pytest.mark.parametrize("rig", sorted(RIGS))
def test_maps_match_reference(rig):
    want = ref_rectify.rectify_maps(**RIGS[rig])
    got = rectify.rectify_maps(**RIGS[rig], device="cpu")
    for name in ("map_left", "map_right"):
        g, w = np_(getattr(got, name)), np_(getattr(want, name))
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-3)
    for name in ("focal", "baseline"):
        np.testing.assert_allclose(np_(getattr(got, name)), np_(getattr(want, name)), rtol=1e-6)
    np.testing.assert_allclose(np_(got.K_new), np_(want.K_new), rtol=1e-6)


def test_identity_rig_maps_are_identity():
    maps = rectify.rectify_maps(**RIGS["identity"], device="cpu")
    yy, xx = np.meshgrid(np.arange(128, dtype=np.float32), np.arange(192, dtype=np.float32),
                         indexing="ij")
    for m in (maps.map_left, maps.map_right):
        np.testing.assert_allclose(np_(m), np.stack([xx, yy], -1), atol=1e-3)
    assert abs(float(maps.focal) - 200.0) < 1e-4 and abs(float(maps.baseline) - 0.5) < 1e-6


@pytest.mark.parametrize("rig", ["rotated", "distorted"])
def test_project_rectified_matches_reference(rng, rig):
    pts = rng.uniform(-1.0, 1.0, (300, 3)).astype(np.float32)
    pts[:, 2] += 6.0
    kw = RIGS[rig]
    ref_maps = ref_rectify.rectify_maps(**kw)
    maps = rectify.rectify_maps(**kw, device="cpu")
    want = ref_rectify.project_rectified(jnp.asarray(pts), ref_maps, kw["R"], kw["T"])
    got = rectify.project_rectified(torch.from_numpy(pts), maps, kw["R"], kw["T"])
    for g, w in zip(got, want):
        np.testing.assert_allclose(np_(g), np_(w), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np_(got[0])[:, 1], np_(got[1])[:, 1], atol=1e-3)  # rows align


@pytest.mark.parametrize("dist", [(-0.12, 0.03, 0.001, -0.0005), (0.05, -0.01, 0.001, 0.0, 0.02)])
def test_distort_normalized_matches_reference(rng, dist):
    xn = rng.uniform(-0.8, 0.8, (50, 40, 2)).astype(np.float32)
    want = ref_rectify.distort_normalized(jnp.asarray(xn), dist)
    got = rectify.distort_normalized(torch.from_numpy(xn), dist)
    np.testing.assert_allclose(np_(got), np_(want), rtol=1e-6, atol=1e-7)


def test_maps_from_arrays_carries_reference_maps():
    want = ref_rectify.rectify_maps(**RIGS["distorted"])
    got = rectify.maps_from_arrays(*(np.asarray(f) for f in want), device="cpu")
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(np_(g), np_(w))
    if not torch.cuda.is_available():  # the card by default: never the CPU unasked
        with pytest.raises(ValueError, match="no CUDA device"):
            rectify.maps_from_arrays(*(np.asarray(f) for f in want))


def test_device_rules_and_backends(rng):
    kw = RIGS["distorted"]
    if not torch.cuda.is_available():  # arrays only: the card by default
        with pytest.raises(ValueError, match="no CUDA device"):
            rectify.rectify_maps(**kw)
    tensors = {k: torch.as_tensor(np.asarray(v, np.float32)) if k in ("K1", "K2", "R", "T")
               else v for k, v in kw.items()}
    maps = rectify.rectify_maps(**tensors)  # the tensors' device
    assert maps.map_left.device.type == "cpu"
    img = rng.uniform(0, 255, (128, 192)).astype(np.float32)
    xla = rectify.rectify_pair(img, img, maps)
    pallas = rectify.rectify_pair(img, img, maps, backend="pallas")
    for a, b in zip(xla, pallas):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="backend"):
        rectify.rectify_pair(img, img, maps, backend="cuda")

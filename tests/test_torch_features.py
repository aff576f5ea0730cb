"""The port's sparse front end (``match.features``) against the JAX
package's.

Harris responses differ in the last bits (XLA's CPU compiler contracts the
reference's jitted products into FMAs), so the test holds the same valid
corner set with ``xy`` within 1e-4, not equal scores. Corners of equal
finite score may come out of ``torch.topk`` in another order than out of
``lax.top_k``, so sets are compared sorted. Matching gives the same pairs
on the reference's shift case."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stepth_tpu.match import features as ref_features
from stepth_tpu_torch.match import features

from tests.test_features import _checker_corners
from tests.torch_port import np_, one_torch_thread  # noqa: F401 (autouse fixture)


def _sorted_valid(c):
    xy = np_(c.xy)[np_(c.valid)]
    return xy[np.lexsort((xy[:, 1], xy[:, 0]))]


def _shift_pair(rng, shift=7):
    """tests/test_features.py::test_matching_recovers_known_shift's pair."""
    tex = rng.uniform(0, 255, (96, 160 + shift)).astype(np.float32)
    k = np.ones(3) / 3
    for ax in (0, 1):
        tex = np.apply_along_axis(lambda m: np.convolve(m, k, mode="same"), ax, tex)
    return tex[:, :160].astype(np.float32), tex[:, shift:].astype(np.float32)


def test_box3_bit_equal(rng):
    x = rng.normal(size=(13, 17)).astype(np.float32)
    np.testing.assert_array_equal(np_(features._box3(torch.from_numpy(x))),
                                  np_(ref_features._box3(jnp.asarray(x))))


@pytest.mark.parametrize("scene", ["checkerboard", "texture"])
def test_harris_same_corner_set(rng, scene):
    img = _checker_corners(rng) if scene == "checkerboard" else _shift_pair(rng)[0]
    kw = dict(max_corners=128, nms_radius=4)
    want = ref_features.harris_corners(jnp.asarray(img), **kw)
    got = features.harris_corners(img, device="cpu", **kw)
    assert got.xy.shape == (128, 2) and got.valid.dtype == torch.bool
    a, b = _sorted_valid(got), _sorted_valid(want)
    assert a.shape == b.shape and a.shape[0] >= 30
    np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)
    # strongest first, padding last with score -inf and xy 0
    s = np_(got.score)
    assert (np.diff(s[np.isfinite(s)]) <= 0).all()
    assert (np_(got.xy)[~np_(got.valid)] == 0).all()
    np.testing.assert_allclose(np.sort(s[np.isfinite(s)]),
                               np.sort(np_(want.score)[np_(want.valid)]), rtol=1e-5)


def test_descriptors_and_matching(rng):
    left, right = _shift_pair(rng)
    c = ref_features.harris_corners(jnp.asarray(left), max_corners=64)
    want = ref_features.describe_patches(jnp.asarray(left), c.xy, size=8)
    got = features.describe_patches(left, np.array(c.xy), size=8, device="cpu")
    np.testing.assert_allclose(np_(got), np_(want), atol=1e-5)
    d2 = np_(want)[::-1].copy()
    v1 = np_(c.valid)
    v2 = v1[::-1].copy()
    wi, wm = ref_features.match_descriptors(want, jnp.asarray(d2), jnp.asarray(v1),
                                            jnp.asarray(v2))
    gi, gm = features.match_descriptors(torch.from_numpy(np.array(want)), torch.from_numpy(d2),
                                        torch.from_numpy(v1), torch.from_numpy(v2))
    np.testing.assert_array_equal(np_(gm), np_(wm))
    np.testing.assert_array_equal(np_(gi)[np_(gm)], np_(wi)[np_(wm)])


def test_match_pair_features_same_pairs(rng):
    left, right = _shift_pair(rng)
    w1, w2 = ref_features.match_pair_features(left, right, max_corners=256)
    g1, g2 = features.match_pair_features(left, right, max_corners=256, device="cpu")
    assert g1.device.type == "cpu" and g1.shape == tuple(w1.shape) and w1.shape[0] >= 30
    order_w, order_g = (np.lexsort((np_(u)[:, 1], np_(u)[:, 0])) for u in (w1, g1))
    np.testing.assert_allclose(np_(g1)[order_g], np_(w1)[order_w], atol=1e-4)
    np.testing.assert_allclose(np_(g2)[order_g], np_(w2)[order_w], atol=1e-4)
    dx = np_(g1)[:, 0] - np_(g2)[:, 0]
    dy = np_(g1)[:, 1] - np_(g2)[:, 1]
    assert ((np.abs(dx - 7) <= 1.0) & (np.abs(dy) <= 1.0)).mean() > 0.8

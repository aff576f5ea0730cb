"""The rest of ``ops/`` in the port against the JAX package, on inputs made
with numpy from a seed: ``mask``, ``resize`` (gray and RGB, up and down,
every filter, ``blur_u8``), ``depth``, ``adjust`` and the u8 ``temporal``
functions exactly (integer results); ``kmeans.depth_split`` exactly,
including the case hypothesis found; ``normalize_brightness_f32`` within 1
LSB on at most 0.1% of pixels (the f32 means sum in another order, the
deviation its module documents; 0 pixels differed here); ``ema_depth``
within 1e-6 relative (the reference's scan may contract its update into an
FMA)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stepth_tpu.ops import adjust as ref_adjust
from stepth_tpu.ops import depth as ref_depth
from stepth_tpu.ops import kmeans as ref_kmeans
from stepth_tpu.ops import mask as ref_mask
from stepth_tpu.ops import photometric as ref_photometric
from stepth_tpu.ops import resize as ref_resize
from stepth_tpu.ops import temporal as ref_temporal
from stepth_tpu.oracle.kmeans import depth_split_oracle
from stepth_tpu_torch.ops import (adjust, depth, kmeans, mask, photometric, resize,
                                  temporal)

from tests.torch_port import np_, one_torch_thread  # noqa: F401 (autouse fixture)


def _data(rng):
    return dict(
        rgba=rng.integers(0, 256, (40, 52, 4), dtype=np.uint8),
        rgb=rng.integers(0, 256, (40, 52, 3), dtype=np.uint8),
        gray=rng.integers(0, 256, (40, 52), dtype=np.uint8),
        mask=rng.choice(np.array([0, 128, 255], np.uint8), (40, 52)),
        mask2=rng.choice(np.array([0, 7, 255], np.uint8), (40, 52)),
        other=rng.integers(0, 256, (30, 45, 4), dtype=np.uint8),
        video=rng.integers(0, 256, (6, 20, 30), dtype=np.uint8),
        masks=rng.choice(np.array([0, 128, 255], np.uint8), (6, 20, 30)),
    )


# name: (reference function, port function, argument names, extra arguments)
OPS = {
    "mask.conform": (ref_mask.conform, mask.conform, ("mask",), ((30, 64), True)),
    "mask.conform_same_size": (ref_mask.conform, mask.conform, ("mask",), ((40, 52),)),
    "mask.mask_and": (ref_mask.mask_and, mask.mask_and, ("mask", "mask2"), ()),
    "mask.mask_or": (ref_mask.mask_or, mask.mask_or, ("mask", "mask2"), ()),
    "mask.mask_not": (ref_mask.mask_not, mask.mask_not, ("mask",), ()),
    "mask.apply": (ref_mask.apply, mask.apply, ("rgba", "mask"), ()),
    "mask.highlight": (ref_mask.highlight, mask.highlight, ("rgba", "mask"), ()),
    "mask.image_replace": (ref_mask.image_replace, mask.image_replace,
                           ("rgba", "mask", "other"), ((3, 4),)),
    "mask.image_replace_origin": (ref_mask.image_replace, mask.image_replace,
                                  ("rgba", "mask", "other"), ()),
    "resize.gaussian_down_rgb": (ref_resize.resample_exact, resize.resample_exact, ("rgb",),
                                 (23, 71, "gaussian")),
    "resize.triangle_up_gray": (ref_resize.resample_exact, resize.resample_exact, ("gray",),
                                (81, 20, "triangle")),
    "resize.catmullrom_rgb": (ref_resize.resample_exact, resize.resample_exact, ("rgb",),
                              (90, 30, "catmullrom")),
    "resize.lanczos3_gray": (ref_resize.resample_exact, resize.resample_exact, ("gray",),
                             (17, 110, "lanczos3")),
    "resize.resize_u8": (ref_resize.resize_u8, resize.resize_u8, ("rgb",), (25, 25)),
    "resize.blur_u8": (ref_resize.blur_u8, resize.blur_u8, ("gray",), (2.0,)),
    "depth.invert": (ref_depth.invert, depth.invert, ("gray",), ()),
    "depth.highlight_depth": (ref_depth.highlight_depth, depth.highlight_depth,
                              ("rgba", "gray"), ()),
    "depth.slice_mask": (ref_depth.slice_mask, depth.slice_mask, ("gray",), (30, 200)),
    "depth.slice_mask_open": (ref_depth.slice_mask, depth.slice_mask, ("gray",), (None, 90)),
    "adjust.brighten": (ref_adjust.brighten, adjust.brighten, ("rgba",), (30,)),
    "adjust.darken": (ref_adjust.brighten, adjust.brighten, ("rgba",), (-70,)),
    "adjust.contrast_up": (ref_adjust.contrast, adjust.contrast, ("rgba",), (37.5,)),
    "adjust.contrast_down": (ref_adjust.contrast, adjust.contrast, ("rgba",), (-30.0,)),
    "adjust.blur": (ref_adjust.blur, adjust.blur, ("rgba",), (1.5,)),
    "adjust.unsharpen": (ref_adjust.unsharpen, adjust.unsharpen, ("rgba",), (1.2, 3)),
    "temporal.temporal_median_depth": (ref_temporal.temporal_median_depth,
                                       temporal.temporal_median_depth, ("video",), (3,)),
    "temporal.temporal_median_depth_5": (ref_temporal.temporal_median_depth,
                                         temporal.temporal_median_depth, ("video",), (5,)),
    "temporal.mask_stabilize": (ref_temporal.mask_stabilize, temporal.mask_stabilize,
                                ("masks",), (3, 2)),
    "temporal.mask_and_video": (ref_temporal.mask_and_video, temporal.mask_and_video,
                                ("masks", "video"), ()),
    "temporal.mask_or_video": (ref_temporal.mask_or_video, temporal.mask_or_video,
                               ("masks", "video"), ()),
    "temporal.motion_mask": (ref_temporal.motion_mask, temporal.motion_mask, ("video",), (4.0,)),
}


@pytest.mark.parametrize("name", sorted(OPS))
def test_op_equals_reference(rng, name):
    ref_fn, fn, names, extra = OPS[name]
    data = _data(rng)
    want = np_(ref_fn(*(jnp.asarray(data[n]) for n in names), *extra))
    got = np_(fn(*(torch.from_numpy(data[n]) for n in names), *extra))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_mask_reset():
    got = mask.reset((3, 5), "cpu")
    np.testing.assert_array_equal(np_(got), np_(ref_mask.reset((3, 5))))


@pytest.mark.parametrize("case", ["random_2", "random_3", "random_4", "random_5", "bimodal",
                                  "hypothesis", "narrow", "constant", "tiny", "one_zone"])
def test_depth_split_equals_reference(rng, case):
    zones = 2
    if case.startswith("random"):
        d, zones = rng.integers(0, 256, (40, 50), dtype=np.uint8), int(case[-1])
    elif case == "bimodal":
        d = np.concatenate([rng.integers(10, 40, 500), rng.integers(200, 240, 500)])
        d = d.astype(np.uint8).reshape(20, 50)
    elif case == "hypothesis":  # stepth_tpu/ops/kmeans.py:58-60: an emptied slot's 0
        d, zones = np.array([[0, 5, 11, 27]], np.uint8), 4
    elif case == "narrow":  # max − min < zones − 1: the step guard
        d, zones = rng.integers(100, 103, (10, 10)).astype(np.uint8), 5
    elif case == "constant":
        d = np.full((8, 8), 42, np.uint8)
    elif case == "tiny":
        d, zones = np.array([[0, 255]], np.uint8), 3
    else:
        d, zones = np.zeros((4, 4), np.uint8), 1
    got = kmeans.depth_split(torch.from_numpy(d), zones)
    assert got == ref_kmeans.depth_split(d, zones) == depth_split_oracle(d, zones)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("shape", [(60, 80, 3), (60, 80)])
def test_normalize_brightness_f32_within_one_lsb(rng, dtype, shape):
    a = rng.integers(0, 256, shape).astype(dtype)
    b = (a * 0.85 + rng.integers(0, 20, shape)).astype(dtype)
    for x, y in ((a, b), (b, a)):
        want = np_(ref_photometric.normalize_brightness_f32(x, y))
        got = np_(photometric.normalize_brightness_f32(torch.from_numpy(x), torch.from_numpy(y)))
        assert got.dtype == want.dtype == dtype
        diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    # within the tolerance: unchanged
    np.testing.assert_array_equal(
        np_(photometric.normalize_brightness_f32(torch.from_numpy(a), torch.from_numpy(a), 0.5)), a)
    np.testing.assert_array_equal(photometric.normalize_brightness_luma16_exact(a, b, 0.01),
                                  ref_photometric.normalize_brightness_luma16_exact(a, b, 0.01))


def test_exact_photometric_copies_equal_reference(rng):
    a = rng.integers(1, 1 << 12, (16, 16, 3), dtype=np.uint16)
    b = (a.astype(np.float64) * [1.5, 0.75, 2.0]).astype(np.uint16)
    np.testing.assert_array_equal(photometric.normalize_brightness_rgb16_exact(a, b, 0.01),
                                  ref_photometric.normalize_brightness_rgb16_exact(a, b, 0.01))


@pytest.mark.parametrize("alpha", [0.5, 0.3])
def test_ema_depth_within_1e_6(rng, alpha):
    v = rng.uniform(0, 255, (7, 20, 30)).astype(np.float32)
    want = np_(ref_temporal.ema_depth(jnp.asarray(v), alpha))
    got = np_(temporal.ema_depth(torch.from_numpy(v), alpha))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)

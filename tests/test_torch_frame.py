"""The port's ``DepthFrame``/``MaskFrame`` (``stepth_tpu_torch.core.frame``)
against the JAX package's on the same arrays: every method, u8 planes bit
for bit, frames on the CPU (``device="cpu"``)."""

import numpy as np
import pytest
import torch

import stepth_tpu
from stepth_tpu.core import io as ref_io
import stepth_tpu_torch
from stepth_tpu_torch import DepthFrame, MaskFrame
from stepth_tpu_torch.core import io

from tests.torch_port import cuda, gxx, np_, one_torch_thread  # noqa: F401 (fixtures)

CPU = "cpu"


def _eq(got, want):
    got, want = np_(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _images(rng, h=24, w=36):
    rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    rgba = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    depth = rng.integers(0, 256, (h, w), dtype=np.uint8)
    return rgb, rgba, depth


def _depth_frames(rng):
    rgb, _, depth = _images(rng)
    ref = stepth_tpu.DepthFrame.from_array(rgb).with_depth(depth)
    got = DepthFrame.from_array(rgb, device=CPU).with_depth(depth)
    return ref, got


def _mask_frames(rng):
    _, rgba, depth = _images(rng)
    mask = np.where(depth > 100, 255, np.where(depth > 60, 128, 0)).astype(np.uint8)
    ref = stepth_tpu.MaskFrame.from_array(rgba).load_mask(mask)
    got = MaskFrame.from_array(rgba, device=CPU).load_mask(mask)
    return ref, got


def test_exports_and_constants():
    for name in ("DepthFrame", "MaskFrame", "MASK_TRUE", "MASK_FALSE", "config"):
        assert name in stepth_tpu_torch.__all__
    assert (stepth_tpu_torch.MASK_TRUE, stepth_tpu_torch.MASK_FALSE) == (
        stepth_tpu.MASK_TRUE, stepth_tpu.MASK_FALSE)


def test_constructors_and_geometry(rng, tmp_path):
    rgb, rgba, _ = _images(rng)
    for image in (rgb, rgba):
        ref = stepth_tpu.DepthFrame.from_array(image)
        got = DepthFrame.from_array(image, device=CPU)
        _eq(got.image, ref.image)
        _eq(got.depth, ref.depth)
        assert (got.width, got.height, got.dimensions) == (ref.width, ref.height, ref.dimensions)
        ref_m = stepth_tpu.MaskFrame.from_array(image)
        got_m = MaskFrame.from_array(torch.from_numpy(image))  # a tensor keeps its device
        _eq(got_m.image, ref_m.image)
        _eq(got_m.mask, ref_m.mask)
        assert got_m.device == torch.device(CPU)
        assert (got_m.width, got_m.height, got_m.dimensions) == (
            ref_m.width, ref_m.height, ref_m.dimensions)
    path = str(tmp_path / "im.png")
    io.save(path, rgb)
    _eq(DepthFrame.open(path, device=CPU).image, stepth_tpu.DepthFrame.open(path).image)
    _eq(MaskFrame.open(path, device=CPU).image, stepth_tpu.MaskFrame.open(path).image)
    with pytest.raises(ValueError, match="expected"):
        DepthFrame.from_array(rgb[..., 0], device=CPU)
    if not torch.cuda.is_available():  # an array goes to the card unless a device is named
        with pytest.raises(ValueError, match="device"):
            DepthFrame.from_array(rgb)


def test_depth_frame_methods(rng, tmp_path):
    ref, got = _depth_frames(rng)
    _eq(got.highlight_depth(), ref.highlight_depth())
    _eq(got.invert_depth().depth, ref.invert_depth().depth)
    assert got.depth_split(3) == ref.depth_split(3)
    _eq(got.slice(40, 200).mask, ref.slice(40, 200).mask)
    _eq(got.slice(None, None).mask, ref.slice(None, None).mask)
    fg_ref, fg_got = ref.select_foreground(), got.select_foreground()
    _eq(fg_got.mask, fg_ref.mask)
    _eq(fg_got.image, fg_ref.image)
    for h, w in ((12, 18), (30, 30)):
        _eq(got.resize(h, w).image, ref.resize(h, w).image)
        _eq(got.resize(h, w).depth, ref.resize(h, w).depth)
    with pytest.raises(ValueError, match="Sizes"):
        got.with_depth(np.zeros((3, 3), np.uint8))
    dpath, ipath = str(tmp_path / "d.png"), str(tmp_path / "i.png")
    got.save_depth(dpath)
    got.save_image(ipath)
    _eq(io.open_luma(dpath), ref.depth)
    _eq(io.open_rgba(ipath), ref.image)
    _eq(got.open_depth(dpath).depth, ref.open_depth(dpath).depth)
    with pytest.raises(AttributeError):
        got.depth = got.depth  # frozen


def test_load_depth_from_additional(rng, tmp_path, gxx):
    """parity (the default), a StereoModel backend and "native" (the C++
    host engine), as tests/test_ops_depth.py:32-45 drives them."""
    tex = rng.uniform(0, 255, (48, 132, 3)).astype(np.uint8)
    main, add = tex[:, :128], tex[:, 4:]
    ref = stepth_tpu.DepthFrame.from_array(main)
    got = DepthFrame.from_array(main, device=CPU)
    want = ref.load_depth_from_additional(add, (36,) * 3)
    _eq(got.load_depth_from_additional(add, (36,) * 3).depth, want.depth)
    d_dense = got.load_depth_from_additional(add, (36,) * 3, method="dense")
    _eq(d_dense.depth, ref.load_depth_from_additional(add, (36,) * 3, method="dense").depth)
    assert d_dense.depth.shape == (48, 128) and int(d_dense.depth.max()) > 0
    path = str(tmp_path / "add.png")
    ref_io.save(path, add)
    _eq(got.open_depth_from_additional(path, (36,) * 3).depth,
        ref.open_depth_from_additional(path, (36,) * 3).depth)
    _eq(got.load_depth_from_additional(add, (36,) * 3, method="native").depth,
        ref.load_depth_from_additional(add, (36,) * 3, method="native").depth)


def test_mask_frame_loading(rng, tmp_path):
    ref, got = _mask_frames(rng)
    _eq(got.mask, ref.mask)
    small = rng.integers(0, 256, (10, 14), dtype=np.uint8)
    for rebin in (False, True):  # quirk Q6: another size is resized, not refused
        _eq(got.load_mask(small, rebin).mask, ref.load_mask(small, rebin).mask)
    path = str(tmp_path / "m.png")
    io.save(path, small)
    _eq(got.load_mask_from_file(path).mask, ref.load_mask_from_file(path).mask)
    _eq(got.load_mask_from_file(path, True).mask, ref.load_mask_from_file(path, True).mask)


def test_mask_frame_algebra(rng):
    ref, got = _mask_frames(rng)
    ref2, got2 = _mask_frames(rng)
    small_ref = stepth_tpu.MaskFrame.from_array(np.zeros((12, 18, 3), np.uint8)).load_mask(
        np.where(np.arange(12 * 18).reshape(12, 18) % 3 == 0, 255, 0).astype(np.uint8))
    small = MaskFrame.from_array(np.zeros((12, 18, 3), np.uint8), device=CPU).load_mask(
        np.asarray(small_ref.mask))
    for other_ref, other in ((ref2, got2), (small_ref, small)):
        _eq(got.mask_and(other).mask, ref.mask_and(other_ref).mask)
        _eq(got.mask_or(other).mask, ref.mask_or(other_ref).mask)
        _eq(got.mask_copy(other).mask, ref.mask_copy(other_ref).mask)
    _eq(got.mask_not().mask, ref.mask_not().mask)
    _eq(got.mask_reset().mask, ref.mask_reset().mask)
    _eq(got.apply_mask().image, ref.apply_mask().image)
    _eq(got.highlight_mask(), ref.highlight_mask())


def test_mask_frame_adjustments_and_io(rng, tmp_path):
    ref, got = _mask_frames(rng)
    ref2, got2 = _mask_frames(rng)
    for start in ((0, 0), (3, 5)):
        _eq(got.image_replace(got2, start).image, ref.image_replace(ref2, start).image)
    _eq(got.image_brightness(40).image, ref.image_brightness(40).image)
    _eq(got.image_brightness(-70).image, ref.image_brightness(-70).image)
    _eq(got.image_contrast(25.0).image, ref.image_contrast(25.0).image)
    _eq(got.image_sharpness(1.5).image, ref.image_sharpness(1.5).image)
    _eq(got.image_blur(1.2).image, ref.image_blur(1.2).image)
    _eq(got.resize(12, 20).image, ref.resize(12, 20).image)
    _eq(got.resize(12, 20).mask, ref.resize(12, 20).mask)
    ipath, mpath = str(tmp_path / "i.png"), str(tmp_path / "m.png")
    got.save(ipath)  # quirk Q7: the image, not the mask
    got.save_mask(mpath)
    _eq(io.open_rgba(ipath), ref.image)
    _eq(io.open_luma(mpath), ref.mask)


def test_readme_foreground_flow(rng):
    """DepthFrame → depth → invert → foreground → apply_mask, end to end."""
    tex = rng.integers(0, 256, (10, 14, 3)).astype(np.float32)
    main = np.kron(tex, np.ones((4, 4, 1), np.float32)).astype(np.uint8)
    add = np.roll(main, 3, axis=1)
    want = stepth_tpu.DepthFrame.from_array(main).load_depth_from_additional(add, (36,) * 3)
    want = want.invert_depth().select_foreground().apply_mask()
    got = DepthFrame.from_array(main, device=CPU).load_depth_from_additional(add, (36,) * 3)
    got = got.invert_depth().select_foreground().apply_mask()
    _eq(got.image, want.image)
    _eq(got.mask, want.mask)


@pytest.mark.cuda
def test_frames_on_card_equal_cpu(cuda, rng):
    tex = rng.integers(0, 256, (10, 14, 3)).astype(np.float32)
    main = np.kron(tex, np.ones((4, 4, 1), np.float32)).astype(np.uint8)
    add = np.roll(main, 3, axis=1)
    out = {}
    for dev in (CPU, cuda):
        f = DepthFrame.from_array(main, device=dev).load_depth_from_additional(add, (36,) * 3)
        m = f.invert_depth().select_foreground().apply_mask()
        out[str(dev)] = [np_(t) for t in (f.depth, m.mask, m.image,
                                           m.image_blur(1.2).image, f.highlight_depth())]
    for a, b in zip(*out.values()):
        np.testing.assert_array_equal(a, b)

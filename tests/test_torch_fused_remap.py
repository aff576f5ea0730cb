"""Kernel K11, the bilinear remap: its plain version (the CPU wrapper runs it)
against the JAX package's ``rectify.remap_bilinear`` and, once, against the
Pallas kernel in interpret mode; on a card, the CUDA kernel against its
plain version.

The cases cover 1–4 channels, widths of every residue mod 4 and maps
with NaN, ±inf and far entries; on the card each also runs on views with
a storage offset. Tolerances: max |Δ| ≤ 1e-4 on 0–255 images, with equal fill masks. The
plain version is not bit-equal to the JAX package: XLA's fused CPU loop
rounds the weighted sum differently (it may contract products into FMAs),
so 16–24% of the pixels of each case differ, by at most 3.1e-5 (measured;
the identity case is bit-equal, and so are the fill masks). The Pallas
kernel sums its candidates in another order, so it is held to the
reference's own 2e-3 (``tests/test_pallas_remap.py``). Kernel and plain
version must be bit-equal on the card.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stepth_tpu.ops import rectify as ref_rectify
from stepth_tpu.ops.pallas_remap import plan_remap, remap_bilinear_pallas
from stepth_tpu_torch.ops import fused_remap, rectify

from tests.test_pallas_remap import _rot_map
from tests.torch_port import cuda, np_, one_torch_thread  # noqa: F401 (fixtures)


def _rig_maps(h, w):
    """test_pallas_remap.py's rig (rotation, distortion in both cameras) at
    (h, w), mapped by the port (``test_torch_rectify.py`` holds its maps to
    the JAX package's)."""
    K = np.array([[180.0, 0, (w - 1) / 2], [0, 180.0, (h - 1) / 2], [0, 0, 1]], np.float32)
    ang = 0.04
    R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]],
                 np.float32)
    T = np.array([-0.6, 0.02, 0.01], np.float32)
    maps = rectify.rectify_maps(K, K, R, T, (h, w), dist1=(0.05, -0.01, 0.001, 0.0),
                                dist2=(-0.04, 0.008, -0.0004, 0.0002), device="cpu")
    return np_(maps.map_left), np_(maps.map_right)


def _wild_map(h, w, sh, sw, rng):
    """A rotation map spiked with NaN, ±inf, ±1e6 and entries just past each
    edge, and entries on the last row and column exactly."""
    m = _rot_map(h, w, sh, sw, 0.05).copy()
    flat = m.reshape(-1, 2)
    idx = rng.choice(flat.shape[0], size=(8, 40), replace=False)
    flat[idx[0], 0] = np.nan
    flat[idx[1], 1] = np.nan
    flat[idx[2], 0] = np.inf
    flat[idx[3], 1] = -np.inf
    flat[idx[4], 0] = 1e6
    flat[idx[5], 1] = -1e6
    flat[idx[6]] = [[sw - 1, sh - 1]]  # the bottom-right pixel: both +1 taps clamp
    flat[idx[7], 0] = np.nextafter(np.float32(sw - 1), np.float32(sw))
    return m


def _case(name, rng):
    """(image, map, fill) of one case."""
    if name == "identity":
        return rng.uniform(0, 255, (64, 160)).astype(np.float32), _rot_map(64, 160, 64, 160, 0.0), 0.0
    if name == "rotation":
        return rng.uniform(0, 255, (96, 200)).astype(np.float32), _rot_map(96, 200, 96, 200, 0.05), 0.0
    if name == "scale_shift_fill":
        img = rng.uniform(0, 255, (80, 256)).astype(np.float32)
        return img, _rot_map(80, 256, 80, 256, -0.12, scale=1.2, shift=(9.3, -4.7)), 3.5
    if name == "other_output_shape":
        img = rng.uniform(0, 255, (100, 180)).astype(np.float32)
        return img, _rot_map(56, 144, 100, 180, 0.08, scale=0.9), 0.0
    if name == "three_channels":
        img = rng.uniform(0, 255, (64, 160, 3)).astype(np.float32)
        return img, _rot_map(64, 160, 64, 160, 0.03, shift=(2.2, 1.1)), 0.0
    if name in ("rig_left", "rig_right"):
        img = rng.uniform(0, 255, (96, 192, 3)).astype(np.float32)
        return img, _rig_maps(96, 192)[name == "rig_right"], 0.0
    # widths that are not multiples of 4 (the kernel's 4-pixel groups) and
    # the channel counts with vector stores
    if name == "two_channels_w161":
        img = rng.uniform(0, 255, (64, 161, 2)).astype(np.float32)
        return img, _rot_map(64, 161, 64, 161, 0.04, shift=(1.3, -0.6)), 0.0
    if name == "four_channels_w162":
        img = rng.uniform(0, 255, (50, 162, 4)).astype(np.float32)
        return img, _rot_map(48, 162, 50, 162, -0.03, scale=1.05), 1.5
    if name == "nan_inf_far_w131":
        img = rng.uniform(0, 255, (70, 131)).astype(np.float32)
        return img, _wild_map(70, 131, 70, 131, rng), -2.0
    assert name == "nan_inf_far"
    return rng.uniform(0, 255, (70, 130)).astype(np.float32), _wild_map(70, 130, 70, 130, rng), -2.0


CASES = ["identity", "rotation", "scale_shift_fill", "other_output_shape", "three_channels",
         "rig_left", "rig_right", "nan_inf_far", "two_channels_w161", "four_channels_w162",
         "nan_inf_far_w131"]


@pytest.mark.parametrize("name", CASES)
def test_plain_matches_reference(rng, name):
    img, m, fill = _case(name, rng)
    want = np_(ref_rectify.remap_bilinear(jnp.asarray(img), jnp.asarray(m), fill=fill))
    before = fused_remap.K11.launches
    got = np_(fused_remap.remap_bilinear_fused(torch.from_numpy(img), torch.from_numpy(m), fill))
    assert fused_remap.K11.launches == before  # a CPU tensor never launches
    assert got.shape == want.shape == m.shape[:2] + img.shape[2:]
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got == fill, want == fill)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    if name == "identity":
        np.testing.assert_array_equal(got, img)  # integer positions: weight 1 exactly
    if name in ("scale_shift_fill", "nan_inf_far"):
        assert 0.01 < (got == fill).mean() < 0.5


def test_plain_matches_pallas_interpret(rng):
    """Once, at 48×128 with a real fill region: the Pallas kernel (interpret
    mode) through its plan."""
    img = rng.uniform(0, 255, (48, 128)).astype(np.float32)
    m = _rot_map(48, 128, 48, 128, -0.05, scale=1.1, shift=(4.1, -2.3))
    spec, plan = plan_remap(m, img.shape, tile_rows=16)
    want = np_(remap_bilinear_pallas(jnp.asarray(img), spec, plan, fill=3.5, interpret=True))
    got = np_(fused_remap.remap_bilinear_plain(torch.from_numpy(img), torch.from_numpy(m), 3.5))
    np.testing.assert_array_equal(got == 3.5, want == 3.5)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)


def test_rectify_pair_pallas_backend_is_the_wrapper(rng):
    img, m, _ = _case("three_channels", rng)
    maps = rectify.maps_from_arrays(m, m, 1.0, 1.0, np.eye(3), device="cpu")
    a, b = rectify.rectify_pair(img, img.astype(np.uint8), maps, backend="pallas")
    np.testing.assert_array_equal(np_(a), np_(fused_remap.remap_bilinear_plain(
        torch.from_numpy(img), maps.map_left)))
    assert b.dtype == torch.float32


def _offset_view(a, device):
    """``a`` on ``device`` as a contiguous view one element into a larger
    buffer: a storage offset, 4-byte but not 16-byte aligned."""
    buf = torch.empty(a.size + 1, dtype=torch.float32, device=device)
    view = buf[1:].view(a.shape)
    view.copy_(torch.as_tensor(a))
    assert view.is_contiguous() and view.storage_offset() == 1
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("name", CASES)
def test_kernel_bit_equal_on_card(cuda, rng, name, offset):
    img, m, fill = _case(name, rng)
    if offset:  # image and map both views with a storage offset
        img_t, m_t = _offset_view(img, cuda), _offset_view(m, cuda)
    else:
        img_t, m_t = torch.as_tensor(img, device=cuda), torch.as_tensor(m, device=cuda)
    before = fused_remap.K11.launches
    got = fused_remap.remap_bilinear_fused(img_t, m_t, fill)
    torch.cuda.synchronize()
    assert fused_remap.K11.launches == before + 1
    assert torch.equal(got, fused_remap.remap_bilinear_plain(img_t, m_t, fill))


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    img = torch.zeros((8, 8), device=cuda)
    m = torch.zeros((8, 8, 2), device=cuda)
    for bad_img, bad_map in ((img.double(), m), (img, m[..., :1].contiguous()),
                             (img[:, ::2], m[:, :4]), (img, m.cpu())):
        with pytest.raises(ValueError):
            fused_remap.remap_bilinear_fused(bad_img, bad_map)

"""The post-processing kernels: K3 (3×3 median), K4 (LR check) and K5
(occlusion fill). Their plain versions vs the Pallas kernels in interpret
mode and the reference's dense functions, and (on a card) each CUDA kernel
vs its plain version. Selections and comparisons only, so every comparison
is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from stepth_tpu.match import dense as ref_dense
from stepth_tpu.match import pallas_post
from stepth_tpu_torch.match import fused_post

from tests.torch_port import cuda, np_, one_torch_thread  # noqa: F401 (fixtures)


@pytest.mark.parametrize("shape", [(37, 130), (64, 256), (9, 7), (2, 3)])
def test_plain_bit_equal_to_pallas_and_dense(rng, shape):
    x = rng.uniform(0, 40, shape).astype(np.float32)
    got = np_(fused_post.median3_fused(torch.from_numpy(x)))
    np.testing.assert_array_equal(got, np_(pallas_post.median3_pallas(jnp.asarray(x), interpret=True)))
    np.testing.assert_array_equal(got, np_(ref_dense.median3(jnp.asarray(x))))


def test_plain_bit_equal_on_plateaus(rng):
    """Integer disparity maps with many ties (the median's usual input)."""
    x = rng.integers(0, 4, (40, 70)).astype(np.float32)
    np.testing.assert_array_equal(
        np_(fused_post.median3_plain(torch.from_numpy(x))),
        np_(pallas_post.median3_pallas(jnp.asarray(x), interpret=True)),
    )


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1080, 1920), (37, 130)])
def test_kernel_bit_equal_on_card(cuda, shape):
    x = torch.as_tensor(
        np.random.default_rng(5).uniform(0, 128, shape).astype(np.float32), device=cuda
    )
    before = fused_post.K3.launches
    got = fused_post.median3_fused(x)
    torch.cuda.synchronize()
    assert fused_post.K3.launches == before + 1
    assert torch.equal(got, fused_post.median3_plain(x))


def _lr_maps(rng, shape, hi=15.0):
    dl = rng.uniform(0, hi, shape).astype(np.float32)
    dr = np.where(rng.uniform(size=shape) < 0.5, dl + rng.normal(0, 1.0, shape), dl)
    dr = dr.astype(np.float32)
    dr[:, 7] = -1e6  # a column no refine candidate reached
    return dl, dr


@pytest.mark.parametrize("num_disparities", [16, 64])
@pytest.mark.parametrize("shape", [(32, 130), (70, 256)])
def test_lr_plain_bit_equal_to_pallas_and_dense(rng, shape, num_disparities):
    """K4's plain version vs ``lr_consistency_pallas`` and
    ``dense.lr_consistency``; the CPU wrapper runs it."""
    dl, dr = _lr_maps(rng, shape)
    got = np_(fused_post.lr_consistency_fused(torch.from_numpy(dl), torch.from_numpy(dr),
                                              1.0, num_disparities))
    want = np_(pallas_post.lr_consistency_pallas(jnp.asarray(dl), jnp.asarray(dr), 1.0,
                                                 num_disparities, interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np_(ref_dense.lr_consistency(jnp.asarray(dl), jnp.asarray(dr), 1.0, num_disparities)))
    assert 0.1 < got.mean() < 0.9


def test_lr_plain_rejects_uncovered_right_view():
    """dR = −1e6 (no candidate covered the column) is never consistent."""
    dl = torch.full((8, 40), 3.0)
    dr = torch.full((8, 40), -1e6)
    assert not fused_post.lr_consistency_plain(dl, dr, 1.0, 16).any()
    assert fused_post.lr_consistency_plain(dl, torch.full((8, 40), 3.0), 1.0, 16)[:, 3:].all()


@pytest.mark.parametrize("shape", [(48, 200), (9, 130)])
def test_fill_plain_bit_equal_to_pallas_and_dense(rng, shape):
    """K5's plain version vs ``fill_invalid_pallas`` and
    ``dense.fill_invalid``: all-invalid and all-valid rows, invalid borders."""
    disp = rng.uniform(0, 60, shape).astype(np.float32)
    valid = rng.uniform(size=shape) > 0.4
    valid[5] = False
    valid[7] = True
    valid[:, :3] = False
    valid[1, -5:] = False
    got = np_(fused_post.fill_invalid_fused(torch.from_numpy(disp), torch.from_numpy(valid)))
    np.testing.assert_array_equal(
        got, np_(pallas_post.fill_invalid_pallas(disp, valid, interpret=True)))
    np.testing.assert_array_equal(got, np_(ref_dense.fill_invalid(disp, valid)))


@pytest.mark.cuda
def test_lr_and_fill_kernels_bit_equal_on_card(cuda):
    rng = np.random.default_rng(5)
    dl, dr = (torch.as_tensor(a, device=cuda) for a in _lr_maps(rng, (1080, 1920), 120.0))
    before = (fused_post.K4.launches, fused_post.K5.launches)
    valid = fused_post.lr_consistency_fused(dl, dr, 1.0, 128)
    filled = fused_post.fill_invalid_fused(dl, valid)
    torch.cuda.synchronize()
    assert (fused_post.K4.launches, fused_post.K5.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(valid, fused_post.lr_consistency_plain(dl, dr, 1.0, 128))
    assert torch.equal(filled, fused_post.fill_invalid_plain(dl, valid))


# ---- NaN, ±inf and ±0, and K3's and K5's edge cases -----------------------
#
# The port's rule: NaN follows torch.minimum/torch.maximum (a NaN operand
# wins every exchange of the median and the fill's minimum), as the
# reference's jnp.minimum/jnp.maximum do; the kernels use the instructions
# torch's CUDA minimum/maximum use, so on the card they equal the plain
# version bit for bit, the sign of a zero included (checked there by the
# cuda-marked cases below and chip_smoke.py phase 3i). jnp.minimum orders
# −0 below +0 and torch's CPU minimum does not, so on the CPU a zero may
# come out with the other sign than the reference's; no matcher writes −0.


def _nan_map(rng, shape):
    """Uniform [0, 40) with NaN, +inf and −inf at interior, edge and corner
    pixels."""
    x = rng.uniform(0, 40, shape).astype(np.float32)
    h, w = shape
    x[0, 0], x[-1, -1], x[0, -1], x[-1, 0] = np.nan, np.inf, -np.inf, np.nan
    x[h // 2, 0], x[0, w // 2], x[h // 2, w // 2] = np.inf, np.nan, -np.inf
    x[h // 3, w // 3], x[-1, w // 3], x[h // 3, -1] = np.nan, -np.inf, np.nan
    return x


def _assert_nan_as_nan(want, got, zero_sign=True):
    """NaN at the same pixels; elsewhere equal bits (``zero_sign``) or equal
    values with bits differing only where the value is a zero."""
    want, got = np_(want), np_(got)
    nw, ng = np.isnan(want), np.isnan(got)
    np.testing.assert_array_equal(nw, ng)
    bw, bg = want.view(np.int32)[~nw], got.view(np.int32)[~ng]
    if zero_sign:
        np.testing.assert_array_equal(bw, bg)
    else:
        np.testing.assert_array_equal(want[~nw], got[~ng])
        assert np.all(want[~nw][bw != bg] == 0)


@pytest.mark.parametrize("shape", [(24, 40), (9, 7), (3, 129)])
def test_median_nan_inf_plain_matches_pallas(rng, shape):
    """A NaN in a 3×3 window makes the median NaN in both (an exchange by
    fminf/fmaxf would drop it); ±inf are ordinary values."""
    x = _nan_map(rng, shape)
    got = fused_post.median3_fused(torch.from_numpy(x))
    assert np.isnan(np_(got)).sum() > 4
    _assert_nan_as_nan(pallas_post.median3_pallas(jnp.asarray(x), interpret=True), got)


@pytest.mark.parametrize("shape", [(24, 40), (9, 7), (3, 129)])
def test_fill_nan_inf_plain_matches_pallas(rng, shape):
    """Valid NaN and ±inf pixels keep their values; an invalid pixel whose
    nearest valid neighbour is NaN or whose minimum is ±inf takes 0."""
    x = _nan_map(rng, shape)
    valid = rng.uniform(size=shape) < 0.5
    valid[0, 0] = valid[shape[0] // 2, 0] = valid[0, shape[1] // 2] = True
    valid[-1, -1] = valid[0, -1] = True
    got = fused_post.fill_invalid_fused(torch.from_numpy(x), torch.from_numpy(valid))
    _assert_nan_as_nan(pallas_post.fill_invalid_pallas(x, valid, interpret=True), got)
    assert np.isnan(np_(got)[valid]).any() and not np.isnan(np_(got)[~valid]).any()


def test_signed_zero_rule_pinned(rng):
    """On a map of ±0 and 1.0 the port's median and fill (the plain
    versions on the CPU) give the reference's values, and differ from its
    bits only in the sign of zeros (jnp.minimum orders −0 below +0)."""
    x = rng.choice(np.array([0.0, -0.0, 1.0], np.float32), size=(16, 40))
    valid = rng.uniform(size=x.shape) < 0.5
    med = fused_post.median3_fused(torch.from_numpy(x))
    _assert_nan_as_nan(fused_post.median3_plain(torch.from_numpy(x)), med)
    _assert_nan_as_nan(pallas_post.median3_pallas(jnp.asarray(x), interpret=True), med,
                       zero_sign=False)
    fill = fused_post.fill_invalid_fused(torch.from_numpy(x), torch.from_numpy(valid))
    _assert_nan_as_nan(fused_post.fill_invalid_plain(torch.from_numpy(x),
                                                     torch.from_numpy(valid)), fill)
    _assert_nan_as_nan(pallas_post.fill_invalid_pallas(x, valid, interpret=True), fill,
                       zero_sign=False)
    np.testing.assert_array_equal(np_(fill)[valid].view(np.int32), x[valid].view(np.int32))


# the small shapes of chip_smoke.K3_EDGES / K5_EDGES (h ≤ 7, w ≤ 129): the
# plain versions against the Pallas kernels, every validity pattern
@pytest.mark.parametrize("h", [1, 2, 3, 7])
@pytest.mark.parametrize("w", [w for w in chip_smoke.POST_EDGE_W if w <= 129])
def test_edges_plain_match_pallas(rng, h, w):
    x = chip_smoke.edge_values(rng, h, w)
    _assert_nan_as_nan(pallas_post.median3_pallas(jnp.asarray(x), interpret=True),
                       fused_post.median3_fused(torch.from_numpy(x)), zero_sign=False)
    for k in range(chip_smoke.FILL_PATTERNS):
        valid = chip_smoke.edge_validity(rng, h, w, k)
        _assert_nan_as_nan(pallas_post.fill_invalid_pallas(x, valid, interpret=True),
                           fused_post.fill_invalid_fused(torch.from_numpy(x),
                                                         torch.from_numpy(valid)),
                           zero_sign=False)


def test_edge_views_plain_match_contiguous(rng):
    """A view that starts one row or one element into its storage gives the
    plain versions the same answer as a contiguous copy."""
    x = chip_smoke.edge_values(rng, 7, 1919)
    valid = chip_smoke.edge_validity(rng, 7, 1919, 0)
    for view in ("row", "element"):
        xv, vv = (chip_smoke.edge_view(a, view, "cpu") for a in (x, valid))
        assert xv.storage_offset() > 0 and vv.storage_offset() > 0
        _assert_nan_as_nan(fused_post.median3_plain(torch.from_numpy(x)),
                           fused_post.median3_fused(xv))
        _assert_nan_as_nan(fused_post.fill_invalid_plain(torch.from_numpy(x),
                                                         torch.from_numpy(valid)),
                           fused_post.fill_invalid_fused(xv, vv))


def _check_post_on_card(cuda, h, w, view=None, seed=9):
    rng = np.random.default_rng(seed)
    x = chip_smoke.edge_view(chip_smoke.edge_values(rng, h, w), view, cuda)
    before = (fused_post.K3.launches, fused_post.K5.launches)
    got = fused_post.median3_fused(x)
    torch.cuda.synchronize()
    assert chip_smoke.bits_equal(fused_post.median3_plain(x), got)
    for k in range(chip_smoke.FILL_PATTERNS):
        valid = chip_smoke.edge_view(chip_smoke.edge_validity(rng, h, w, k), view, cuda)
        got = fused_post.fill_invalid_fused(x, valid)
        torch.cuda.synchronize()
        assert chip_smoke.bits_equal(fused_post.fill_invalid_plain(x, valid), got), k
    assert (fused_post.K3.launches, fused_post.K5.launches) == (
        before[0] + 1, before[1] + chip_smoke.FILL_PATTERNS)


@pytest.mark.cuda
@pytest.mark.parametrize("h, w", chip_smoke.K3_EDGES)
def test_edges_kernels_bit_equal_on_card(cuda, h, w):
    """``chip_smoke.K3_EDGES``/``K5_EDGES``: NaN where the plain version has
    NaN, the same bits (the sign of zeros included) elsewhere."""
    _check_post_on_card(cuda, h, w)


@pytest.mark.cuda
@pytest.mark.parametrize("h, w, view", chip_smoke.POST_EDGE_VIEWS)
def test_edge_views_kernels_bit_equal_on_card(cuda, h, w, view):
    """Views one row into a width-1919 map (scalar path) or a width-1920 map
    (vector path), and one element into a buffer (misaligned)."""
    _check_post_on_card(cuda, h, w, view)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(24, 40), (9, 7), (3, 129), (1080, 1920)])
def test_nan_maps_kernels_bit_equal_on_card(cuda, shape):
    """The CPU cases' NaN/±inf maps: K3 propagates NaN as its plain version
    does, K5 keeps valid NaN and ±inf."""
    rng = np.random.default_rng(3)
    x = torch.as_tensor(_nan_map(rng, shape), device=cuda)
    valid = torch.as_tensor(rng.uniform(size=shape) < 0.5, device=cuda)
    got = fused_post.median3_fused(x)
    torch.cuda.synchronize()
    assert torch.isnan(got).sum() > 4
    assert chip_smoke.bits_equal(fused_post.median3_plain(x), got)
    assert chip_smoke.bits_equal(fused_post.fill_invalid_plain(x, valid),
                                 fused_post.fill_invalid_fused(x, valid))

"""The post-processing kernels: K3 (3×3 median), K4 (LR check) and K5
(occlusion fill). Their plain versions vs the Pallas kernels in interpret
mode and the reference's dense functions, and (on a card) each CUDA kernel
vs its plain version. Selections and comparisons only, so every comparison
is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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

"""K3, the 3×3 median: its plain version vs ``median3_pallas(interpret=True)``
and ``dense.median3``, and (on a card) the CUDA kernel vs the plain version.
A selection, so every comparison is bit-equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stepth_tpu.match import dense as ref_dense
from stepth_tpu.match import pallas_post
from stepth_tpu_torch.match import fused_post

from tests.torch_port import cuda, np_  # noqa: F401 (fixture)


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

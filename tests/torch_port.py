"""Shared helpers for the PyTorch-port tests (``test_torch_*.py``).

The port's tests feed the same numpy inputs, made from a seed, to a JAX
function of ``stepth_tpu`` and to its twin in ``stepth_tpu_torch``.
"""

import shutil

import numpy as np
import pytest
import torch


def assert_close(ref_disp, ref_valid, got_disp, got_valid, atol=0.05):
    """The reference's kernel-vs-XLA rule (tests/test_pallas_dense.py:15-24):
    valid masks agree on > 99.9% of pixels and the 99.9th percentile of
    |Δd| over pixels valid in both is ≤ ``atol`` px. f32 box sums taken in
    another order may move a subpixel value at a degenerate parabola."""
    ref_valid = np.asarray(ref_valid, bool)
    got_valid = np.asarray(got_valid, bool)
    agree = (ref_valid == got_valid).mean()
    assert agree > 0.999, agree
    d = np.abs(np.asarray(ref_disp, np.float64) - np.asarray(got_disp, np.float64))
    both = ref_valid & got_valid
    assert np.quantile(d[both], 0.999) <= atol


def np_(t):
    """A torch tensor (any device) or JAX array as a numpy array."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


@pytest.fixture()
def cuda():
    """The CUDA device; skips the test where there is no card (a CUDA kernel
    has no CPU mode). Decided per test, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture()
def gxx():
    """Skips the test where there is no ``g++`` to build the native host
    engine (``stepth_tpu_torch.native``)."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the native host engine")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one CPU thread for the module, restored after it. The suite
    runs several pytest workers on one machine; with torch's default of one
    thread per core in each, its parallel ops oversubscribe the cores and
    small-tensor tests run ~20× slower than alone. An autouse fixture acts
    where it is imported."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

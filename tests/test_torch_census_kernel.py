"""The census kernel (``csrc/fused_census.cu``) against its plain version.

``dense.census_pair`` launches the kernel on CUDA tensors and runs the
plain census (``census_pair_plain``: a stack of both views, then
``census_planes``) on CPU tensors; the two must give the same int32 planes
bit for bit, with bit 31 as the sign bit and edge-replicated neighbours.
The kernels' plain versions take their census from ``census_pair_plain`` on
any device, so on the card they stay the kernel's yardstick. This file
imports neither JAX nor the JAX package, so the card can run it without
``tests/conftest.py`` (which imports JAX): ``pytest --noconftest
tests/test_torch_census_kernel.py``, from the repository's root with this
``tests`` directory importable as the package ``tests``. The plain census
is held to the JAX package's in ``tests/test_torch_dense.py``."""

import numpy as np
import pytest
import torch

from stepth_tpu_torch.config import MatchConfig, PyramidConfig, SGMConfig
from stepth_tpu_torch.match import dense, fused_dense, fused_refine, fused_sgm
from stepth_tpu_torch.utils import tracing

from tests.torch_port import cuda, one_torch_thread  # noqa: F401 (fixtures)

WINDOWS = [3, 5, 7, 9, 11, 13, 15]
# the keyframe's four levels, KITTI's frame, and shapes smaller than a window
SHAPES = [(1080, 1920), (540, 960), (270, 480), (135, 240), (375, 1242), (7, 5), (1, 1)]
KINDS = ["luma", "constant", "ties", "signed_zeros"]
CENSUS = MatchConfig(num_disparities=16, window=5, cost="census", census_window=5)
PYR = PyramidConfig(levels=3, refine_radius=2, coarsest_disparities=4)


def gray_pair(kind, h, w, seed=0, device="cpu"):
    """Two gray f32 [h, w] views of one kind:

    - luma: ``dense.grayscale`` of random u8 RGB (on ``device``);
    - constant: one value everywhere (every bit 0);
    - ties: integers 0–3, so most neighbours equal the centre;
    - signed_zeros: mostly −0.0 and +0.0 (equal, so no bit), some ±1, ±inf
      and NaN (never greater, never less)."""
    rng = np.random.default_rng(seed)
    if kind == "luma":
        rgb = torch.from_numpy(rng.integers(0, 256, (2, h, w, 3), dtype=np.uint8)).to(device)
        return dense.grayscale(rgb[0]), dense.grayscale(rgb[1])
    if kind == "constant":
        g = np.full((2, h, w), 87.25, np.float32)
    elif kind == "ties":
        g = rng.integers(0, 4, (2, h, w)).astype(np.float32)
    else:
        vals = np.array([-0.0, 0.0, -0.0, 0.0, -0.0, 0.0, 1.0, -1.0, np.inf, -np.inf, np.nan],
                        np.float32)
        g = vals[rng.integers(0, len(vals), (2, h, w))]
    g = torch.from_numpy(g).to(device)
    return g[0], g[1]


def _scene(h=48, w=96, shift=6):
    left = torch.rand((h, w), generator=torch.Generator().manual_seed(0)) * 255
    return left, torch.roll(left, -shift, dims=1)


@pytest.mark.parametrize("window", WINDOWS)
def test_census_pair_on_cpu_is_the_plain_census(window):
    """CPU tensors: ``census_pair`` equals ``census_pair_plain`` bit for bit
    (shapes larger and smaller than the window), adds one to
    ``census.plain`` a pair and launches nothing."""
    before, launches = tracing.counters(), dense.CENSUS.launches
    shapes = [(37, 70), (7, 5), (1, 1)]
    for (h, w), kind in zip(shapes, ("luma", "ties", "signed_zeros")):
        left, right = gray_pair(kind, h, w)
        got, want = dense.census_pair(left, right, window), dense.census_pair_plain(
            left, right, window)
        for g, wnt in zip(got, want):
            assert g.dtype == torch.int32 and g.is_contiguous()
            assert torch.equal(g, wnt)
    now = tracing.counters()
    assert now["census.plain"] - before.get("census.plain", 0) == len(shapes)
    assert now.get("census.kernel", 0) == before.get("census.kernel", 0)
    assert dense.CENSUS.launches == launches


def _no_census_pair(*_args):
    raise AssertionError("a plain path called dense.census_pair")


@pytest.mark.parametrize("path", ["match_hierarchical_plain", "raw_match_plain",
                                  "match_pair_sgm_plain", "seeded_plain"])
def test_plain_paths_take_the_plain_census(monkeypatch, path):
    """The kernels' plain versions (K1's, K2's through the plain pyramid and
    a plain seeded frame, K6's through the plain SGM) compute their census
    with ``census_pair_plain``, never ``census_pair``."""
    left, right = _scene()
    monkeypatch.setattr(dense, "census_pair", _no_census_pair)
    if path == "match_hierarchical_plain":
        res = fused_refine.match_hierarchical_plain(left, right, CENSUS, PYR, lr_check=True,
                                                    device="cpu")
        out = res.disparity
    elif path == "raw_match_plain":
        out = fused_dense.raw_match_plain(left, right, CENSUS)[0]
    elif path == "match_pair_sgm_plain":
        out = fused_sgm.match_pair_sgm_plain(left, right, CENSUS, SGMConfig(directions=2),
                                             device="cpu").disparity
    else:
        prior = torch.full_like(left, 6.0)
        out = fused_refine.seeded_frame(fused_refine.PLAIN, left, right, prior, CENSUS, PYR,
                                        lr_check=True, device="cpu").disparity
    assert out.shape == left.shape


@pytest.mark.cuda
@pytest.mark.parametrize("h, w", SHAPES)
@pytest.mark.parametrize("window", WINDOWS)
def test_kernel_census_equals_plain_on_card(cuda, window, h, w):
    """One launch a pair, bit-equal to the plain census on every kind of
    input; a constant image has no bit set."""
    for kind in KINDS:
        left, right = gray_pair(kind, h, w, seed=window, device=cuda)
        before, launches = tracing.counters(), dense.CENSUS.launches
        got = dense.census_pair(left, right, window)
        assert dense.CENSUS.launches == launches + 1
        assert tracing.counters()["census.kernel"] - before.get("census.kernel", 0) == 1
        want = dense.census_pair_plain(left, right, window)
        for view, g, wnt in zip(("left", "right"), got, want):
            assert g.dtype == torch.int32 and g.is_contiguous(), (kind, view)
            assert g.shape == wnt.shape, (kind, view)
            assert torch.equal(g, wnt), (kind, view, int((g != wnt).sum()))
            if kind == "constant":
                assert not g.any(), view


@pytest.mark.cuda
def test_census_kernel_rejects_what_it_does_not_take(cuda):
    """No fallback: f64, 3-D, non-contiguous, mismatched shapes or devices,
    and census windows outside 2–15 raise, and nothing is launched."""
    g = torch.rand((16, 24), device=cuda)
    launches = dense.CENSUS.launches
    for left, right, window in (
            (g.double(), g.double(), 7),
            (g[None], g[None], 7),
            (g.t(), g.t(), 7),
            (g, torch.rand((16, 20), device=cuda), 7),
            (g, g.cpu(), 7),
            (g, g, 1),
            (g, g, 17)):
        with pytest.raises(ValueError):
            dense.census_pair(left, right, window)
    assert dense.CENSUS.launches == launches


@pytest.mark.cuda
def test_plain_pipeline_takes_no_census_kernel_on_card(cuda):
    """On CUDA tensors the plain pipeline launches no census kernel; the
    kernel pipeline launches one a level (the coarse K1 and each K2 level),
    counted as ``census.kernel``, and both give the same frame."""
    left, right = (t.to(cuda) for t in _scene(96, 256))
    launches, before = dense.CENSUS.launches, tracing.counters()
    plain = fused_refine.match_hierarchical_plain(left, right, CENSUS, PYR, lr_check=True)
    assert dense.CENSUS.launches == launches
    got = fused_refine.match_hierarchical_fused(left, right, CENSUS, PYR, lr_check=True)
    assert dense.CENSUS.launches == launches + PYR.levels
    counted = {k: tracing.counters().get(k, 0) - before.get(k, 0)
               for k in ("census.kernel", "census.plain")}
    assert counted == {"census.kernel": PYR.levels, "census.plain": 0}
    assert torch.equal(got.valid, plain.valid)
    assert torch.equal(torch.nan_to_num(got.disparity, nan=-1.0),
                       torch.nan_to_num(plain.disparity, nan=-1.0))

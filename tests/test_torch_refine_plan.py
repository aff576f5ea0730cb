"""K2_PLAN, the refine plan's kernel, against the plan's plain version.

``fused_refine.plan_level`` pads the prior, then plans it with K2_PLAN on
CUDA tensors and with ``tile_windows_from_prior`` (plain torch) on CPU
tensors; the two must give the same ``bases`` and ``nw`` bit for bit. This
file imports neither JAX nor the JAX package, so the card can run it
without ``tests/conftest.py`` (which imports JAX): ``pytest --noconftest
tests/test_torch_refine_plan.py``, from the repository's root with this
``tests`` directory importable as the package ``tests``. The plain plan is
held to the JAX package's in ``tests/test_torch_fused_refine.py``."""

import itertools

import numpy as np
import pytest
import torch

from stepth_tpu_torch.config import MatchConfig, PyramidConfig
from stepth_tpu_torch.match import fused_refine

from tests.torch_port import cuda, one_torch_thread  # noqa: F401 (fixtures)

KINDS = ["smooth", "step", "ramp", "halves", "groups", "noise"]
CFG = MatchConfig(num_disparities=32, window=9)
PYR = PyramidConfig(levels=3, refine_radius=4, coarsest_disparities=8)


def plan_prior(kind, h, w, max_base, seed=0):
    """A prior f32[h, w] of one kind:

    - smooth: 12 plus unit noise (one window a tile);
    - step: +10 px after a third of the columns, −7 in the lower right;
    - ramp: a linear ramp over ``[0, max_base]`` across the columns (windows
      tiled over its span, up to the cap);
    - halves: integers, 8×8 subtiles of b and b + 1 in a checkerboard, so
      every whole tile's mean is exactly b + 0.5 (round-half-even);
    - groups: integers in three groups 9 apart, so the cover ends before K
      windows (the 1e30 sentinel) and its midpoints fall on exact halves;
    - noise: uniform over ``[−5, max_base + 5]`` (the cap and the clip)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    if kind == "smooth":
        p = 12 + rng.normal(0, 1, (h, w))
    elif kind == "step":
        p = 6 + rng.normal(0, 1, (h, w)) + 10 * (x >= w // 3) - 7 * ((y >= h // 2) & (x >= 2 * w // 3))
    elif kind == "ramp":
        p = x * (max_base / w) + y * 0.05
    elif kind == "halves":
        p = 10 + x // 128 % 7 + (x // 8 + y // 8) % 2
    elif kind == "groups":
        p = 5 + 9 * ((x // 8 + 3 * (y // 8)) % 3) + x // 64 % 2
    else:
        p = rng.uniform(-5, max_base + 5, (h, w))
    return torch.from_numpy(np.ascontiguousarray(p, np.float32))


def _gather_padded(prior, tile_rows):
    """The edge pad as an index gather (the pad ``plan_level`` replaced)."""
    h, w = prior.shape
    rows = torch.arange(-(-h // tile_rows) * tile_rows).clamp(max=h - 1)
    cols = torch.arange(-(-w // 128) * 128).clamp(max=w - 1)
    return prior[rows][:, cols]


@pytest.mark.parametrize("kind", KINDS)
def test_plan_level_on_cpu_runs_the_plain_plan(kind):
    """CPU tensors: ``plan_level`` is the plain plan of the edge-padded prior,
    with ``tile_rows`` rounded up to a multiple of 8, and launches nothing."""
    before = fused_refine.K2_PLAN.launches
    for (h, w), tile_rows, max_windows in (((72, 300), 20, 16), ((40, 130), 8, 4),
                                           ((3, 100), 64, 1)):
        prior = plan_prior(kind, h, w, 64)
        bases, nw, tr = fused_refine.plan_level(prior, tile_rows, 64, 2, max_windows)
        assert tr == -(-tile_rows // 8) * 8
        want_b, want_n = fused_refine.tile_windows_from_prior(
            _gather_padded(prior, tr), tr, 64, 2, max_windows)
        assert torch.equal(bases, want_b) and torch.equal(nw, want_n)
    assert fused_refine.K2_PLAN.launches == before


def _pair(device="cpu", h=64, w=256, shift=5):
    left = torch.rand((h, w), generator=torch.Generator().manual_seed(0)) * 255
    return left.to(device), torch.roll(left, -shift, dims=1).to(device)


@pytest.mark.parametrize("path, other", [("match_hierarchical_plain", "plan_level"),
                                         ("match_hierarchical_fused", "plan_level_plain")])
def test_each_pipeline_plans_with_its_own_plan(monkeypatch, path, other):
    """The plain pipeline plans with ``plan_level_plain`` (``PLAIN.plan``)
    and the kernel pipeline with ``plan_level`` (``FUSED.plan``), never the
    other's: on the card the kernel path's plan is then held to an
    independent one."""
    plans = []
    refine_level = fused_refine._refine_level

    def record(stages, *args):
        plans.append(stages.plan)
        return refine_level(stages, *args)

    monkeypatch.setattr(fused_refine, "_refine_level", record)
    left, right = _pair()
    res = getattr(fused_refine, path)(left, right, CFG, PYR, lr_check=True, device="cpu")
    assert res.disparity.shape == left.shape
    assert len(plans) == PYR.levels - 1 and getattr(fused_refine, other) not in plans


def test_plain_plan_level_equals_plan_level_on_cpu():
    """``plan_level_plain`` is ``plan_level`` on CPU tensors, launches included."""
    before = fused_refine.K2_PLAN.launches
    for kind in KINDS:
        prior = plan_prior(kind, 72, 300, 64)
        got, want = (f(prior, 20, 64, 2, 16) for f in (fused_refine.plan_level_plain,
                                                        fused_refine.plan_level))
        assert got[2] == want[2] == 24
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert fused_refine.K2_PLAN.launches == before


def test_fused_plan_takes_only_cuda_tensors():
    """No fallback: the kernel's wrapper raises on a CPU tensor."""
    with pytest.raises(ValueError, match="CUDA"):
        fused_refine.tile_windows_fused(torch.zeros(64, 128), 64, 32, 2, 16)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("h, w", [(270, 480), (540, 960), (1080, 1920), (375, 1242)])
def test_kernel_plan_equals_plain_on_card(cuda, h, w, kind):
    """K2_PLAN, one launch a ``plan_level`` call, bit-equal to the plain plan
    of the same padded prior over tile_rows 8–64 (20 rounds up to 24),
    max_windows 1, 4 and 16, max_base 32, 64 and 128, radius 2 and 4."""
    multi = early = 0
    for tile_rows, max_windows, max_base, radius in itertools.product(
            (8, 16, 20, 32, 64), (1, 4, 16), (32, 64, 128), (2, 4)):
        prior = plan_prior(kind, h, w, max_base).to(cuda)
        before = fused_refine.K2_PLAN.launches
        bases, nw, tr = fused_refine.plan_level(prior, tile_rows, max_base, radius, max_windows)
        assert fused_refine.K2_PLAN.launches == before + 1
        want_b, want_n = fused_refine.tile_windows_from_prior(
            fused_refine.pad_prior(prior, tr), tr, max_base, radius, max_windows)
        case = (tile_rows, max_windows, max_base, radius)
        assert bases.dtype == nw.dtype == torch.int32, case
        assert torch.equal(bases, want_b), case
        assert torch.equal(nw, want_n), case
        K = bases.shape[-1]
        multi += int((nw > 1).sum())
        early += int(((nw > 1) & (nw < K)).sum())
    if kind in ("step", "ramp", "groups", "noise"):
        assert multi > 0  # the greedy cover ran
    if kind == "groups":
        assert early > 0  # and ended before K windows


@pytest.mark.cuda
def test_fused_plan_rejects_a_misaligned_prior(cuda):
    """K2_PLAN reads subtile rows as float4: a prior that is not 16-byte
    aligned is refused, not read."""
    buf = torch.zeros(64 * 128 + 1, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        fused_refine.tile_windows_fused(buf[1:].view(64, 128), 64, 32, 2, 16)


@pytest.mark.cuda
def test_plain_pipeline_plans_without_the_kernel_on_card(cuda):
    """On CUDA tensors the plain pipeline, and a seeded frame on it, plan in
    plain torch (no K2_PLAN launch); the kernel pipeline launches K2_PLAN
    once a refine level, and both give the same frame."""
    left, right = _pair(cuda)
    before = fused_refine.K2_PLAN.launches
    plain = fused_refine.match_hierarchical_plain(left, right, CFG, PYR, lr_check=True)
    fused_refine.seeded_frame(fused_refine.PLAIN, left, right, plain.disparity, CFG, PYR,
                              lr_check=True)
    assert fused_refine.K2_PLAN.launches == before
    got = fused_refine.match_hierarchical_fused(left, right, CFG, PYR, lr_check=True)
    assert fused_refine.K2_PLAN.launches == before + PYR.levels - 1
    assert torch.equal(got.valid, plain.valid)
    assert torch.equal(torch.nan_to_num(got.disparity, nan=-1.0),
                       torch.nan_to_num(plain.disparity, nan=-1.0))

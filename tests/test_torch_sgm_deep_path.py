"""The SGM matcher past 256 disparities: 8 directions with ``256 < D ≤ 512``,
where K7's staged kernel runs on its deep tiling (ND = 10, 12 or 16 path
costs a lane), every direction is scanned and stored, and K9 takes the WTA
from the stored sum, then K4.

On the CPU the program's plain path equals the benchmark's reference of
this path (``portbench/reference/sgm_deep.py``) bit for bit on the
``middlebury2014-f-sgm8-census`` configuration at small sizes, the
counters split K7's launches by the tiling they take, the spans put each
deep scan inside its scan (and its diagonal) span, and K10 refuses a
volume past its limit by name. On the card K7's deep tiling equals the
plain scan on edge shapes, and the kernel path equals the plain path at
the configuration's own 1988×2880, D=290, stage by stage. This file
imports neither JAX nor the JAX package, so the card can run it without
``tests/conftest.py``: ``pytest --noconftest tests/test_torch_sgm_deep_path.py``
from the repository's root with this ``tests`` directory importable as the
package ``tests``."""

import contextlib
import copy
import json
import pathlib

import numpy as np
import pytest
import torch

import chip_smoke
from portbench import traffic
from portbench.reference import sgm_deep
from stepth_tpu_torch.config import from_dict
from stepth_tpu_torch.match import dense, fused_sgm, sgm as sgm_mod
from stepth_tpu_torch.models.stereo import StereoModel
from stepth_tpu_torch.utils import tracing

from tests.torch_port import cuda, one_torch_thread  # noqa: F401 (fixtures)

CONFIGS = pathlib.Path(__file__).resolve().parents[1] / "portbench" / "configs"
DEEP = json.loads((CONFIGS / "middlebury2014-f-sgm8-census.json").read_text())
CELL = traffic.load("middlebury-f-sgm8-census-box")
ARROWS = ("→x", "←x", "↘", "↙", "↗", "↖", "↓y", "↑y")  # fused_sgm.directions(8)


def model_cfg(D=None):
    cfg = copy.deepcopy(DEEP["model"])
    if D is not None:
        cfg["match"]["num_disparities"] = D
    return cfg


def frames(shape, seed, n=1, device="cpu"):
    """The cell's first ``n`` frames at ``shape``: f32 RGB [n, H, W, 3]."""
    lefts, rights = traffic.make_pool(CELL, shape, seed)
    return (torch.as_tensor(lefts[:n], device=device).to(torch.float32),
            torch.as_tensor(rights[:n], device=device).to(torch.float32))


def same(a, b):
    """Equal bits, on the tensors' own device (f32 compared as int32)."""
    a, b = torch.as_tensor(a), torch.as_tensor(b).to(torch.as_tensor(a).device)
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def _delta(before):
    now = tracing.counters()
    return {k: now[k] - before.get(k, 0) for k in now if now[k] != before.get(k, 0)}


@pytest.mark.parametrize("seed", [7, 2 ** 31 + 11])
def test_plain_path_equals_the_reference(seed):
    cfg = model_cfg()
    model = from_dict(StereoModel, cfg)
    ls, rs = frames((8, 640), seed)
    (d, v), = sgm_deep.run_call(ls, rs, cfg, CELL)
    got = fused_sgm.match_pair_sgm_plain(ls[0], rs[0], model.match, model.sgm)
    assert same(got.disparity, d) and same(got.valid, v)
    assert (d > 256).any()  # the range past K7's tiles up to 256 is used


def test_reference_refuses_what_it_does_not_follow():
    for change in ({"num_disparities": 256}, {"num_disparities": 513}, {"cost": "sad"}):
        cfg = model_cfg()
        cfg["match"].update(change)
        with pytest.raises(ValueError, match="sgm_deep"):
            sgm_deep.check_config(cfg)


def test_each_frame_counts_the_stored_wta_path():
    model = from_dict(StereoModel, model_cfg())
    ls, rs = frames((4, 300), 3, n=2)
    before = tracing.counters()
    for t in range(2):
        model(ls[t], rs[t])
    assert _delta(before) == {"sgm.wta_stored": 2}  # no K7 counter on CPU tensors


def test_spans_put_each_deep_scan_inside_its_scan_and_diagonal(monkeypatch):
    """Each scan at D > 256 opens ``stepth/sgm/deep`` inside its
    ``stepth/sgm/scan`` (and inside ``stepth/sgm/diagonal`` for the four
    diagonals), recorded here as the stack of open spans at each
    ``stepth/sgm/`` span's entry (``test_torch_sgm_stored_path.py`` reads the
    same spans from a ``torch.profiler`` trace)."""
    open_, entered = [], []

    @contextlib.contextmanager
    def span(name):
        open_.append(name)
        entered.append(tuple(open_))
        yield
        open_.pop()

    monkeypatch.setattr(fused_sgm.tracing, "span", span)
    model = from_dict(StereoModel, model_cfg(257))
    ls, rs = frames((2, 24), 5)
    model(ls[0], rs[0])
    sgm_spans = [tuple(n for n in s if n.startswith("stepth/sgm/")) for s in entered
                 if s[-1].startswith("stepth/sgm/")]
    scan, diagonal = ("stepth/sgm/scan",), ("stepth/sgm/scan", "stepth/sgm/diagonal")
    deep = [s for s in sgm_spans if s[-1] == "stepth/sgm/deep"]
    assert deep == [s + ("stepth/sgm/deep",) for s in [scan] * 2 + [diagonal] * 4 + [scan] * 2]
    names = [s[-1] for s in sgm_spans]
    assert {n: names.count(n) for n in set(names)} == {
        "stepth/sgm/volume": 1, "stepth/sgm/scan": 8, "stepth/sgm/diagonal": 4,
        "stepth/sgm/deep": 8, "stepth/sgm/wta": 1}


@pytest.fixture()
def launches(monkeypatch):
    """K7's and K10's launches, recorded instead of made, on meta tensors
    standing for the card's (132 SMs)."""
    calls = []
    monkeypatch.setattr(fused_sgm, "_sm_count", lambda device: 132)
    monkeypatch.setattr(fused_sgm.kernels, "check_cuda_tensor", lambda *a: None)
    monkeypatch.setattr(fused_sgm.K7, "launch", lambda dev, *a: calls.append(("K7", a)))
    monkeypatch.setattr(fused_sgm.K10, "launch", lambda dev, *a: calls.append(("K10", a)))
    return calls


@pytest.mark.parametrize("D, h, w, counted", [
    (290, 1988, 2880, {"sgm.scan_deep": 8}),  # the Middlebury F frame: all on the deep tiling
    (512, 37, 64, {"sgm.scan_deep": 8}),
    (257, 1, 1, {"sgm.scan_deep": 8}),
    (256, 1080, 1920, {"sgm.scan_ring": 6, "sgm.scan_staged": 2}),  # the box cell's
    (256, 1080, 5120, {"sgm.scan_staged": 8}),
    (128, 375, 1242, {"sgm.scan_staged": 8}),  # KITTI's D
])
def test_counters_split_k7_launches_by_tiling(launches, D, h, w, counted):
    """Each K7 launch counts once, on ``sgm.scan_deep`` past D = 256 (the
    staged kernel's deep tiling, never the ring: no schedule is passed),
    else on ``sgm.scan_ring`` or ``sgm.scan_staged``."""
    vol = torch.empty((D, h, w), device="meta")
    before = tracing.counters()
    for axis, reverse, shift in fused_sgm.directions(8):
        fused_sgm.scan_direction(vol, torch.empty_like(vol), 8.0, 32.0, axis=axis,
                                 reverse=reverse, shift=shift)
    assert _delta(before) == counted
    assert len(launches) == 8
    if D > 256:
        assert all(a[11] is None and a[12] == 0 and a[13] is None for _, a in launches)


def test_k10_and_k7_refuse_past_their_limits_by_name(launches):
    """The sharded relay's K10 keeps D ≤ 256 and K7 D ≤ 512: past them the
    wrappers raise before any launch, naming the limit."""
    for reverse, shift in ((False, 0), (True, 1)):
        with pytest.raises(ValueError, match="K10.*D ≤ 256, got 257"):
            fused_sgm.scan_direction_carry(torch.empty((257, 40, 64), device="meta"), None,
                                           None, 8.0, 32.0, reverse=reverse, shift=shift)
    with pytest.raises(ValueError, match="D ≤ 512, got 513"):
        fused_sgm.scan_direction(torch.empty((513, 4, 64), device="meta"), None, 8.0, 32.0,
                                 axis=2, reverse=False)
    fused_sgm.scan_direction_carry(torch.empty((256, 40, 64), device="meta"), None, None, 8.0,
                                   32.0, reverse=False, shift=0)
    assert [k for k, _ in launches] == ["K10"]


# ---- on a card ------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("acc_mode", ["none", "separate", "in_place"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [257, 290, 320, 512])
def test_deep_scan_edges_match_plain_on_card(cuda, D, dtype, acc_mode):
    """K7 on its deep tiling bit-equal to its plain version in all eight
    directions on ``chip_smoke.K7_EDGE_SHAPES`` (ragged bands and stages,
    one row, one column, rows whose pitch is no multiple of 16 bytes),
    each launch counted on ``sgm.scan_deep``; ``acc`` None, a separate
    tensor, or updated in place (``chip_smoke.check_edges`` repeats these
    cases on the card)."""
    rng = np.random.default_rng(D)
    for h, w in chip_smoke.K7_EDGE_SHAPES:
        vol = torch.from_numpy(rng.integers(0, 50, (D, h, w)).astype(np.float32)).to(cuda)
        acc0 = torch.from_numpy(rng.integers(0, 500, (D, h, w)).astype(np.float32)).to(cuda)
        vol, acc0 = vol.to(dtype), acc0.to(dtype)
        for axis, reverse, shift in fused_sgm.directions(8):
            kw = dict(axis=axis, reverse=reverse, shift=shift)
            dy, dx = fused_sgm._step(axis, reverse, shift)
            acc = None if acc_mode == "none" else acc0.clone()
            want = fused_sgm.scan_direction_plain(vol, None if acc is None else acc.clone(),
                                                  25.0, 100.0, **kw)
            before = tracing.counters()
            if acc_mode == "separate":  # out beside acc, which stays as it was
                got = torch.empty_like(vol)
                fused_sgm._launch_k7(vol, acc, got, dy, dx, 25.0, 100.0)
            else:
                got = fused_sgm.scan_direction(vol, acc, 25.0, 100.0, **kw)
            torch.cuda.synchronize()
            assert _delta(before) == {"sgm.scan_deep": 1}, (h, w, kw)
            assert torch.equal(got, want), (h, w, kw)
            if acc_mode == "separate":
                assert torch.equal(acc, acc0), (h, w, kw)
            if acc_mode == "in_place":
                assert got.data_ptr() == acc.data_ptr()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_path_equals_the_plain_path_at_the_cells_size(cuda, dtype):
    """K6 on census planes, each K7 scan on the deep tiling (four
    diagonal), K9 with K4 and the whole frame through ``__call__``, at
    1988×2880 and D=290, against their plain versions, with an f32 volume
    (the cell's) and a bf16 one (its control)."""
    cfg_ = model_cfg()
    cfg_["sgm"]["volume_dtype"] = {torch.float32: "f32", torch.bfloat16: "bf16"}[dtype]
    model = from_dict(StereoModel, cfg_)
    cfg, sg = model.match, model.sgm
    ls, rs = frames(tuple(DEEP["shape"]), 2 ** 31 + 3, device=cuda)
    lg, rg = dense.grayscale(ls[0]), dense.grayscale(rs[0])
    vol = fused_sgm.aggregated_volume(lg, rg, cfg, dtype)
    assert same(vol, fused_sgm.aggregated_volume_plain(lg, rg, cfg, dtype))
    p1, p2 = sgm_mod.penalties(cfg, sg)
    acc = acc_plain = None
    for (axis, reverse, shift), arrow in zip(fused_sgm.directions(8), ARROWS):
        acc = fused_sgm.scan_direction(vol, acc, p1, p2, axis=axis, reverse=reverse,
                                       shift=shift)
        acc_plain = fused_sgm.scan_direction_plain(vol, acc_plain, p1, p2, axis=axis,
                                                   reverse=reverse, shift=shift)
        assert same(acc, acc_plain), arrow
    del vol, acc_plain
    for got, want in zip(fused_sgm.wta_from_volume(acc, cfg),
                         fused_sgm.wta_from_volume_plain(acc, cfg)):
        assert same(got, want)
    del acc
    got = model(ls[0], rs[0])
    want = fused_sgm.match_pair_sgm_plain(ls[0], rs[0], cfg, sg)
    assert same(got.disparity, want.disparity) and same(got.valid, want.valid)

"""The SGM matcher's stored-sum path: 8 directions with ``128 < D ≤ 256``,
where every direction is scanned and stored (K7, four of them diagonal)
and K9 takes the WTA from the stored sum, then K4.

On the CPU the program's plain path equals the benchmark's reference of
this path (``portbench/reference/sgm_wide.py``) bit for bit on the
``hd1080-sgm8-census`` configuration at small sizes, the frame counters
say which WTA path a frame took, and the spans split the diagonal scans
and the WTA out. On the card the kernel path equals the plain path at the
configuration's own 1080×1920, D=256, stage by stage. This file imports
neither JAX nor the JAX package, so the card can run it without
``tests/conftest.py``: ``pytest --noconftest
tests/test_torch_sgm_stored_path.py`` from the repository's root with this
``tests`` directory importable as the package ``tests``."""

import copy
import json
import pathlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import traffic
from portbench.reference import sgm_wide
from stepth_tpu_torch.config import from_dict
from stepth_tpu_torch.match import dense, fused_sgm, sgm as sgm_mod
from stepth_tpu_torch.models.stereo import StereoModel
from stepth_tpu_torch.utils import tracing

from tests.torch_port import cuda, one_torch_thread  # noqa: F401 (fixtures)

CONFIGS = pathlib.Path(__file__).resolve().parents[1] / "portbench" / "configs"
WIDE = json.loads((CONFIGS / "hd1080-sgm8-census.json").read_text())
KITTI = json.loads((CONFIGS / "kitti2015-sgm.json").read_text())
CELL = traffic.load("hd1080-sgm8-census-box")


def model_cfg(config, D=None):
    cfg = copy.deepcopy(config["model"])
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


@pytest.mark.parametrize("D", [160, 256])
@pytest.mark.parametrize("seed", [7, 2 ** 31 + 11])
def test_plain_path_equals_the_reference(D, seed):
    cfg = model_cfg(WIDE, D)
    model = from_dict(StereoModel, cfg)
    ls, rs = frames((16, 320), seed)
    (d, v), = sgm_wide.run_call(ls, rs, cfg, CELL)
    got = fused_sgm.match_pair_sgm_plain(ls[0], rs[0], model.match, model.sgm)
    assert same(got.disparity, d) and same(got.valid, v)
    assert (d > 128).any()  # the range past the fused WTA's is used


def _delta(before):
    now = tracing.counters()
    return {k: now[k] - before.get(k, 0) for k in now if now[k] != before.get(k, 0)}


@pytest.mark.parametrize("config,shape,counted", [
    (WIDE, (16, 288), "sgm.wta_stored"), (KITTI, (16, 160), "sgm.wta_fused")],
    ids=["stored", "fused"])
def test_each_frame_counts_its_wta_path(config, shape, counted):
    model = from_dict(StereoModel, model_cfg(config))
    ls, rs = frames(shape, 3, n=2)
    before = tracing.counters()
    for t in range(2):
        model(ls[t], rs[t])
    assert _delta(before) == {counted: 2}


def test_spans_split_the_diagonals_and_the_wta(tmp_path):
    model = from_dict(StereoModel, model_cfg(WIDE, 136))  # the profiler's cost is per op
    ls, rs = frames((8, 144), 5)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model(ls[0], rs[0])
    prof.export_chrome_trace(str(tmp_path / "trace.json"))  # cheaper than prof.events()
    events = [e for e in json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("name", "").startswith("stepth/sgm/")]
    names = [e["name"] for e in events]
    assert {n: names.count(n) for n in set(names)} == {
        "stepth/sgm/volume": 1, "stepth/sgm/scan": 8, "stepth/sgm/diagonal": 4,
        "stepth/sgm/wta": 1}
    scans = [e for e in events if e["name"] == "stepth/sgm/scan"]
    for e in events:
        if e["name"] == "stepth/sgm/diagonal":
            assert any(s["tid"] == e["tid"] and s["ts"] <= e["ts"]
                       and e["ts"] + e["dur"] <= s["ts"] + s["dur"] for s in scans)


@pytest.mark.cuda
def test_kernel_path_equals_the_plain_path_at_the_cells_size(cuda):
    """K6 on census planes, each K7 scan (four diagonal), K9 with K4 and the
    whole frame, at 1080×1920 and D=256, against their plain versions."""
    model = from_dict(StereoModel, model_cfg(WIDE))
    cfg, sg = model.match, model.sgm
    ls, rs = frames(tuple(WIDE["shape"]), 2 ** 31 + 3, device=cuda)
    lg, rg = dense.grayscale(ls[0]), dense.grayscale(rs[0])
    vol = fused_sgm.aggregated_volume(lg, rg, cfg)
    assert same(vol, fused_sgm.aggregated_volume_plain(lg, rg, cfg))
    p1, p2 = sgm_mod.penalties(cfg, sg)
    acc = acc_plain = None
    for axis, reverse, shift in fused_sgm.directions(8):
        acc = fused_sgm.scan_direction(vol, acc, p1, p2, axis=axis, reverse=reverse,
                                       shift=shift)
        acc_plain = fused_sgm.scan_direction_plain(vol, acc_plain, p1, p2, axis=axis,
                                                   reverse=reverse, shift=shift)
        assert same(acc, acc_plain), (axis, reverse, shift)
    del vol, acc_plain
    for got, want in zip(fused_sgm.wta_from_volume(acc, cfg),
                         fused_sgm.wta_from_volume_plain(acc, cfg)):
        assert same(got, want)
    del acc
    got = fused_sgm.match_pair_sgm_fused(ls[0], rs[0], cfg, sg)
    want = fused_sgm.match_pair_sgm_plain(ls[0], rs[0], cfg, sg)
    assert same(got.disparity, want.disparity) and same(got.valid, want.valid)

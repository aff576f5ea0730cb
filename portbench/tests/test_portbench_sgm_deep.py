"""The ``middlebury-f-sgm8-census-box`` cell: the reference past 256
disparities (``reference/sgm_deep.py``) lists the launches of the
program's path and marks its scans as run inside ``stepth/sgm/deep``, the
cell resolves by name and passes its rehearsal on the CPU, its control
fails the check, and the readers of the deep scans' span count the kernels
launched inside it, set them against the marked launches' bound, and find
nothing where the program has no such span."""

import json
import subprocess
import sys

import pytest
import torch

from portbench import control, record, roofline, run, traffic
from portbench.metrics import sgm_deep_scan_ms_per_frame, sgm_deep_scan_roofline_pct
from portbench.reference import sgm_deep
from portbench.trace import Trace

CELL = "middlebury-f-sgm8-census-box"
CONFIG = json.loads((run.HERE / "configs" / "middlebury2014-f-sgm8-census.json").read_text())
POST = ["lr_check_kernel", "fill_invalid_kernel", "median3_kernel"]


def test_record_lists_the_deep_paths_launches():
    lefts, rights = traffic.make_pool(traffic.load(CELL), CONFIG["rehearsal_shape"], 3)
    ls, rs = (torch.as_tensor(a[:1]).to(torch.float32) for a in (lefts, rights))
    rec = []
    sgm_deep.run_call(ls, rs, CONFIG["model"], {}, record=rec)
    launches = rec[0]
    assert [launch["kernel"] for launch in launches] == (
        ["census_pair_kernel", "sgm_volume_kernel"] + ["sgm_scan_kernel"] * 8 +
        ["sgm_wta_kernel"] + POST)
    h, w = CONFIG["rehearsal_shape"]
    V = 290 * h * w
    scans = [launch for launch in launches if launch["kernel"] == "sgm_scan_kernel"]
    assert [launch["bytes"] for launch in scans] == [8 * V] + [12 * V] * 7
    assert all(launch["span"] == "stepth/sgm/deep" for launch in scans)
    assert [launch for launch in launches if "span" in launch] == scans
    assert launches[0]["bytes"] == 2 * (4 + 4 * 2) * h * w  # two census planes a view


@pytest.mark.parametrize("change", [{"sgm": {"directions": 4}},
                                    {"match": {"num_disparities": 256}},
                                    {"match": {"num_disparities": 513}},
                                    {"sgm": {"volume_dtype": "bf16"}}])
def test_reference_refuses_what_it_does_not_follow(change):
    cfg = control._merge(CONFIG["model"], change)
    with pytest.raises(ValueError):
        sgm_deep.check_config(cfg)


def test_cells_resolve_with_their_references_and_metrics():
    spec = run.resolve(CELL)
    assert spec["config"] == CONFIG and spec["config"]["reference"] == "sgm_deep"
    assert spec["traffic"] == traffic.load(CELL)
    per_layer = {m["name"] for m in spec["per_layer"]}
    assert {"sgm_deep_scan_ms_per_frame", "sgm_deep_scan_roofline_pct"} <= per_layer
    assert "sgm_deep_scan_ms_per_frame" not in {
        m["name"] for m in run.resolve("hd1080-sgm8-census-box")["per_layer"]}
    edges = run.resolve("hd1080-prod-seeded-edges")
    assert edges["config"]["reference"] == "hierarchical"
    assert edges["traffic"]["entry"] == "video" and edges["traffic"]["content"] == "scene"


def test_rehearsal_is_correct():
    p = subprocess.run(
        [sys.executable, str(run.HERE / "run.py"), "--workload", CELL,
         "--seed", "4000000007", "--seconds", "0.3", "--rehearse", "--trace", "1"],
        capture_output=True, text=True, timeout=600, cwd=run.ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["rehearsal"] and out["correct"] and out["check"]["frames"] >= 5


def test_the_control_fails_the_check():
    rows = control.readings(CELL, [21, 2 ** 32 + 3], torch.device("cpu"))
    assert all(not r["correct"] and r["disp_px"] > 0 for r in rows), rows


@pytest.mark.cuda
def test_the_control_fails_the_check_at_the_cells_size(cuda):
    rows = control.readings(CELL, [31, 32, 33], cuda)
    assert all(not r["correct"] and r["disp_px"] > 0 for r in rows), rows


def ev(name, cat, ts, dur, tid, correlation=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid}
    if correlation is not None:
        e["args"] = {"correlation": correlation}
    return e


def deep_trace(spans=True):
    """Two calls on the serving thread (tid 7): two scans each, the first
    diagonal, every scan's launch inside its deep span (when the program
    opens them), then K9 outside; each launch by correlation id."""
    events = [ev("portbench/call", "user_annotation", 0, 400, 7),
              ev("portbench/call", "user_annotation", 400, 600, 7)]
    if spans:
        for t0 in (100, 500):
            events += [ev("stepth/sgm/scan", "user_annotation", t0, 50, 7),
                       ev("stepth/sgm/diagonal", "user_annotation", t0 + 1, 48, 7),
                       ev("stepth/sgm/deep", "user_annotation", t0 + 2, 46, 7),
                       ev("stepth/sgm/scan", "user_annotation", t0 + 60, 40, 7),
                       ev("stepth/sgm/deep", "user_annotation", t0 + 61, 38, 7)]
    return events + [
        ev("cudaLaunchKernel", "cuda_runtime", 110, 5, 7, 1),
        ev("cudaLaunchKernel", "cuda_runtime", 170, 5, 7, 2),
        ev("cudaLaunchKernel", "cuda_runtime", 510, 5, 7, 3),
        ev("cudaLaunchKernel", "cuda_runtime", 570, 5, 7, 4),
        ev("cudaLaunchKernel", "cuda_runtime", 620, 5, 7, 5),  # K9, outside
        ev("sgm_scan_kernel", "kernel", 200, 300, 0, 1),
        ev("sgm_scan_kernel", "kernel", 500, 100, 0, 2),
        ev("sgm_scan_kernel", "kernel", 600, 300, 0, 3),
        ev("sgm_scan_kernel", "kernel", 900, 100, 0, 4),
        ev("sgm_wta_kernel", "kernel", 1000, 60, 0, 5),
    ]


def run_of(events, launches=()):
    return record.Run(setup_s=1.0, window_s=1.0, chunk=1, calls=[],
                      trace=Trace(events, ["sgm_scan_kernel", "sgm_wta_kernel"]),
                      traced_frames=2, launches=list(launches))


def test_readers_set_the_deep_spans_kernels_against_the_marked_bound():
    marked = dict(roofline.launch("sgm_scan_kernel", 3.35e12 * 100e-6, 0),
                  span="stepth/sgm/deep")  # 100 µs at the peak bandwidth
    other = roofline.launch("sgm_wta_kernel", 3.35e12 * 1e-3, 0)
    run_ = run_of(deep_trace(), [marked] * 4 + [other] * 2)
    assert sgm_deep_scan_ms_per_frame.read(run_) == pytest.approx(800 / 1e3 / 2)
    assert sgm_deep_scan_roofline_pct.read(run_) == pytest.approx(100 * 400 / 800)


def test_readers_find_nothing_without_the_spans():
    marked = dict(roofline.launch("sgm_scan_kernel", 1e9, 0), span="stepth/sgm/deep")
    readers = (sgm_deep_scan_ms_per_frame, sgm_deep_scan_roofline_pct)
    run_ = run_of(deep_trace(spans=False), [marked])
    assert [r.read(run_) for r in readers] == [None, None]
    run_ = run_of(deep_trace(), [roofline.launch("sgm_scan_kernel", 1e9, 0)])
    assert sgm_deep_scan_roofline_pct.read(run_) is None  # no launch marked
    run_.trace = None
    assert [r.read(run_) for r in readers] == [None, None]

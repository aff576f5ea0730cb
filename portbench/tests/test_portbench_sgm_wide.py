"""The ``hd1080-sgm8-census-box`` cell: the stored-sum SGM reference
(``reference/sgm_wide.py``) lists the launches of the program's path, the
cell resolves by name and passes its rehearsal on the CPU, its control
fails the check, and the readers of the SGM's WTA and diagonal spans count
the kernels launched inside them and nothing where the program has no such
span."""

import json
import subprocess
import sys

import pytest
import torch

from portbench import control, record, run, traffic
from portbench.metrics import sgm_diagonal_ms_per_frame, sgm_wta_ms_per_frame
from portbench.reference import sgm_wide
from portbench.trace import Trace

CELL = "hd1080-sgm8-census-box"
CONFIG = json.loads((run.HERE / "configs" / "hd1080-sgm8-census.json").read_text())
POST = ["lr_check_kernel", "fill_invalid_kernel", "median3_kernel"]


def test_record_lists_the_stored_sum_paths_launches():
    lefts, rights = traffic.make_pool(traffic.load(CELL), CONFIG["rehearsal_shape"], 3)
    ls, rs = (torch.as_tensor(a[:1]).to(torch.float32) for a in (lefts, rights))
    rec = []
    sgm_wide.run_call(ls, rs, CONFIG["model"], {}, record=rec)
    launches = rec[0]
    assert [launch["kernel"] for launch in launches] == (
        ["sgm_volume_kernel"] + ["sgm_scan_kernel"] * 8 + ["sgm_wta_kernel"] + POST)
    h, w = CONFIG["rehearsal_shape"]
    V = 256 * h * w
    scans = [launch["bytes"] for launch in launches if launch["kernel"] == "sgm_scan_kernel"]
    assert scans == [8 * V] + [12 * V] * 7  # the first scan reads no running sum
    assert launches[9]["bytes"] == 4 * V + 16 * h * w and launches[9]["ops"] == 3 * V


@pytest.mark.parametrize("change", [{"sgm": {"directions": 4}},
                                    {"match": {"num_disparities": 128}},
                                    {"sgm": {"volume_dtype": "bf16"}}])
def test_reference_refuses_what_it_does_not_follow(change):
    cfg = control._merge(CONFIG["model"], change)
    with pytest.raises(ValueError):
        sgm_wide.check_config(cfg)


def test_cell_resolves_with_its_own_reference_and_metrics():
    spec = run.resolve(CELL)
    assert spec["config"] == CONFIG and spec["config"]["reference"] == "sgm_wide"
    assert spec["traffic"] == traffic.load(CELL)
    per_layer = {m["name"] for m in spec["per_layer"]}
    assert {"sgm_wta_ms_per_frame", "sgm_diagonal_ms_per_frame"} <= per_layer
    assert "sgm_wta_ms_per_frame" not in {m["name"] for m in run.resolve("kitti2015-sgm")
                                          ["per_layer"]}
    assert run.resolve("hd1080-prod-seeded")["config"]["reference"] == "hierarchical"


def test_rehearsal_is_correct():
    p = subprocess.run(
        [sys.executable, str(run.HERE / "run.py"), "--workload", CELL,
         "--seed", "4000000007", "--seconds", "0.3", "--rehearse", "--trace", "1"],
        capture_output=True, text=True, timeout=600, cwd=run.ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["rehearsal"] and out["correct"] and out["check"]["frames"] >= 9


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


def sgm_trace(spans=True):
    """Two calls on the serving thread (tid 7): a scan span holding a
    diagonal one, a plain scan, and the WTA span; each launch by
    correlation id."""
    events = [ev("portbench/call", "user_annotation", 0, 400, 7),
              ev("portbench/call", "user_annotation", 400, 600, 7)]
    if spans:
        events += [ev("stepth/sgm/scan", "user_annotation", 100, 50, 7),
                   ev("stepth/sgm/diagonal", "user_annotation", 101, 48, 7),
                   ev("stepth/sgm/scan", "user_annotation", 160, 40, 7),
                   ev("stepth/sgm/scan", "user_annotation", 500, 50, 7),
                   ev("stepth/sgm/diagonal", "user_annotation", 501, 48, 7),
                   ev("stepth/sgm/wta", "user_annotation", 600, 100, 7)]
    return events + [
        ev("cudaLaunchKernel", "cuda_runtime", 110, 5, 7, 1),  # diagonal
        ev("cudaLaunchKernel", "cuda_runtime", 170, 5, 7, 2),  # straight
        ev("cudaLaunchKernel", "cuda_runtime", 510, 5, 7, 3),  # diagonal
        ev("cudaLaunchKernel", "cuda_runtime", 610, 5, 7, 4),  # K9
        ev("cudaLaunchKernel", "cuda_runtime", 650, 5, 7, 5),  # K4
        ev("cudaLaunchKernel", "cuda_runtime", 620, 5, 9, 6),  # another thread
        ev("sgm_scan_kernel", "kernel", 200, 300, 0, 1),
        ev("sgm_scan_kernel", "kernel", 500, 100, 0, 2),
        ev("sgm_scan_kernel", "kernel", 600, 300, 0, 3),
        ev("sgm_wta_kernel", "kernel", 900, 60, 0, 4),
        ev("lr_check_kernel", "kernel", 960, 10, 0, 5),
        ev("k", "kernel", 970, 10, 0, 6),
    ]


def run_of(events):
    return record.Run(setup_s=1.0, window_s=1.0, chunk=1, calls=[],
                      trace=Trace(events, ["sgm_scan_kernel", "sgm_wta_kernel"]),
                      traced_frames=2)


def test_readers_count_the_kernels_launched_inside_the_spans():
    run_ = run_of(sgm_trace())
    assert sgm_diagonal_ms_per_frame.read(run_) == pytest.approx((300 + 300) / 1e3 / 2)
    assert sgm_wta_ms_per_frame.read(run_) == pytest.approx((60 + 10) / 1e3 / 2)


def test_readers_find_nothing_without_the_spans():
    run_ = run_of(sgm_trace(spans=False))
    readers = (sgm_diagonal_ms_per_frame, sgm_wta_ms_per_frame)
    assert [r.read(run_) for r in readers] == [None, None]
    run_.trace = None
    assert [r.read(run_) for r in readers] == [None, None]

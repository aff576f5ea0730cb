"""The readers of the program's own spans and counters on a small synthetic
Chrome trace: launches, plan host time and census device time count only
what the serving thread issued inside the named spans; each reader finds
nothing where the program has no spans or counters."""

import pytest

from portbench import record
from portbench.metrics import (census_ms_per_frame, launches_per_frame, loader_starved_pct,
                               plan_host_ms)
from portbench.trace import Trace
from stepth_tpu_torch.utils import tracing


def ev(name, cat, ts, dur, tid=None, correlation=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid}
    if correlation is not None:
        e["args"] = {"correlation": correlation}
    return e


def stretch():
    """The benchmark's two calls over [0, 1000) µs on the serving thread."""
    return [ev("portbench/call", "user_annotation", 0, 400, 7),
            ev("portbench/call", "user_annotation", 400, 600, 7)]


def program_trace():
    """Two program calls on the serving thread (tid 7), each with a plan and
    a census span. Runtime events on tid 7 and on a loader worker (tid 9)
    launch work by correlation id; one launch on tid 7 falls between the
    calls, and a sync puts no work on the card."""
    return stretch() + [
        ev("stepth/call", "user_annotation", 100, 250, 7),
        ev("stepth/call", "user_annotation", 450, 300, 7),
        ev("stepth/plan", "user_annotation", 120, 40, 7),
        ev("stepth/plan", "user_annotation", 470, 60, 7),
        ev("stepth/census", "user_annotation", 200, 50, 7),
        ev("stepth/census", "user_annotation", 600, 50, 7),
        ev("cudaLaunchKernel", "cuda_runtime", 130, 5, 7, 1),  # plan
        ev("cudaLaunchKernel", "cuda_runtime", 210, 5, 7, 2),  # census
        ev("cuLaunchKernel", "cuda_driver", 220, 5, 7, 3),  # census
        ev("cudaMemsetAsync", "cuda_runtime", 300, 5, 7, 4),
        ev("cudaLaunchKernel", "cuda_runtime", 400, 5, 7, 5),  # between the calls
        ev("cudaLaunchKernel", "cuda_runtime", 610, 5, 7, 6),  # census
        ev("cudaStreamSynchronize", "cuda_runtime", 620, 5, 7, 7),  # puts no work
        ev("cudaMemcpyAsync", "cuda_runtime", 210, 5, 9, 8),  # the loader's, in a span's time
        ev("census_a", "kernel", 300, 30, 0, 2),
        ev("census_b", "kernel", 340, 20, 0, 3),
        ev("census_c", "kernel", 700, 50, 0, 6),
        ev("plan_k", "kernel", 140, 10, 0, 1),
        ev("Memset (Device)", "gpu_memset", 310, 2, 0, 4),
        ev("k", "kernel", 410, 10, 0, 5),
        ev("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 220, 10, 0, 8),
    ]


def run_of(events):
    return record.Run(setup_s=1.0, window_s=1.0, chunk=1, calls=[],
                      trace=Trace(events, ["plan_k"]), traced_frames=2)


def test_readers_count_the_serving_threads_work_inside_the_spans():
    run_ = run_of(program_trace())
    # correlations 1, 2, 3, 4 and 6: not the launch between the calls, the
    # sync or the loader's copy
    assert launches_per_frame.read(run_) == pytest.approx(5 / 2)
    assert plan_host_ms.read(run_) == pytest.approx((40 + 60) / 1e3 / 2)
    assert census_ms_per_frame.read(run_) == pytest.approx((30 + 20 + 50) / 1e3 / 2)


def test_readers_find_nothing_without_the_programs_spans():
    run_ = run_of(stretch() + [ev("cudaLaunchKernel", "cuda_runtime", 130, 5, 7, 1),
                               ev("k", "kernel", 140, 10, 0, 1)])
    readers = (launches_per_frame, plan_host_ms, census_ms_per_frame)
    assert [r.read(run_) for r in readers] == [None, None, None]
    run_.trace = None
    assert [r.read(run_) for r in readers] == [None, None, None]


def test_loader_starved_share_reads_the_programs_counters(monkeypatch):
    run_ = record.Run(setup_s=1.0, window_s=1.0, chunk=1, calls=[])
    monkeypatch.setattr(tracing, "_counters", {})
    assert loader_starved_pct.read(run_) is None
    monkeypatch.setattr(tracing, "_counters", {"loader.takes": 40})
    assert loader_starved_pct.read(run_) == 0.0
    monkeypatch.setattr(tracing, "_counters", {"loader.takes": 40, "loader.starved": 2})
    assert loader_starved_pct.read(run_) == pytest.approx(5.0)

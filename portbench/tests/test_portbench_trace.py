"""The trace readers on a small synthetic Chrome trace."""

import pytest

from portbench import record, roofline, run
from portbench.metrics import (device_idle_pct, glue_ms_per_frame, kernel_ms_per_frame,
                               kernel_roofline_pct)
from portbench.trace import Trace, port_kernel_names


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def synthetic():
    """Two calls over [0, 1000) µs: the device busy 100-300 (two port
    kernels overlapping a copy), 500-600 (glue) and 900-950 (a port kernel
    with its launch before the stretch's end)."""
    return [
        ev("portbench/call", "user_annotation", 0, 400),
        ev("portbench/call", "user_annotation", 400, 600),
        ev("portbench/loader_wait", "user_annotation", 0, 90),
        ev("portbench/model_call", "user_annotation", 90, 700),
        ev("portbench/to_host", "user_annotation", 790, 210),
        ev("aten::nonzero", "cpu_op", 290, 170),
        ev("aten::add", "cpu_op", 320, 5),
        ev("void fused_refine_kernel<true>(RefArgs)", "kernel", 100, 100),
        ev("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 150, 100),
        ev("median3_kernel(float const*, float*, int, int)", "kernel", 250, 50),
        ev("void at::native::vectorized_elementwise_kernel<4>(...)", "kernel", 500, 100),
        ev("void fused_refine_kernel<false>(RefArgs)", "kernel", 900, 50),
        ev("outside", "kernel", 2000, 10),  # past the stretch
    ]


NAMES = ["fused_refine_kernel", "median3_kernel", "refine_emit_r_kernel"]


def test_busy_share_and_idle_gaps():
    t = Trace(synthetic(), NAMES)
    assert t.calls == 2
    assert t.window_s == pytest.approx(1e-3)
    assert t.busy_s() == pytest.approx(350e-6)
    gaps = t.idle_gaps()
    assert [g[1] for g in gaps] == pytest.approx([300e-6, 200e-6, 100e-6, 50e-6])
    assert [g[0] for g in gaps] == ["model_call", "model_call: aten::nonzero",
                                    "loader_wait", "to_host"]


def test_port_kernels_and_glue_per_frame():
    t = Trace(synthetic(), NAMES)
    port, glue = t.kernel_seconds()
    assert port == {"fused_refine_kernel": pytest.approx([100e-6, 50e-6]),
                    "median3_kernel": pytest.approx([50e-6])}
    assert glue == pytest.approx(100e-6)
    run_ = record.Run(setup_s=1.0, window_s=1.0, chunk=1, calls=[], trace=t, traced_frames=2)
    assert glue_ms_per_frame.read(run_) == pytest.approx(0.05)
    assert kernel_ms_per_frame.read(run_) == pytest.approx(0.1)
    assert device_idle_pct.read(run_) == pytest.approx(65.0)
    ops = t.device_ops()
    assert ops[0] == ["fused_refine_kernel", pytest.approx(150e-6)]


def test_roofline_share_counts_what_the_reference_counts():
    t = Trace(synthetic(), NAMES)
    launches = [roofline.launch("fused_refine_kernel", 3.35e12 * 40e-6, 0),
                roofline.launch("fused_refine_kernel", 3.35e12 * 10e-6, 0),
                roofline.launch("median3_kernel", 0, 67e12 * 25e-6)]
    run_ = record.Run(setup_s=1.0, window_s=1.0, chunk=1, calls=[], trace=t,
                      traced_frames=2, launches=launches)
    assert kernel_roofline_pct.read(run_) == pytest.approx(100 * 75 / 200)
    assert run_.notes == []
    # launches the trace and the reference count differently stay in both sums
    # and are named: the basis is the reference's whole list
    run_.launches = launches + [roofline.launch("median3_kernel", 3.35e12 * 5e-6, 0),
                                roofline.launch("sgm_scan_kernel", 3.35e12 * 20e-6, 0)]
    assert kernel_roofline_pct.read(run_) == pytest.approx(100 * 100 / 200)
    assert [n.split()[1] for n in run_.notes] == ["median3_kernel", "sgm_scan_kernel"]
    run_.trace = None
    assert kernel_roofline_pct.read(run_) is None


def test_bound_takes_the_larger_of_bytes_and_operations():
    assert roofline.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert roofline.bound_s(0, 67e12) == pytest.approx(1.0)
    assert roofline.bound_s(3.35e12, 2 * 67e12) == pytest.approx(2.0)
    assert roofline.cost_ops("census", 9, 2) == 13
    assert roofline.cost_ops("sad", 5, 1) == 10


def test_the_programs_kernel_names_are_found():
    names = port_kernel_names(run.ROOT / run.PROGRAM)
    for n in ("fused_dense_kernel", "fused_refine_kernel", "refine_emit_r_kernel",
              "median3_kernel", "lr_check_kernel", "fill_invalid_kernel",
              "sgm_volume_kernel", "sgm_scan_kernel", "sgm_scan_wta_kernel"):
        assert n in names


def test_kernel_names_come_from_every_source_of_the_package(tmp_path):
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "a.cu").write_text("__global__ void __launch_bounds__(256) k_a(int x)")
    (tmp_path / "csrc" / "b.cuh").write_text("template <int N> __global__ void k_b (float* p)")
    (tmp_path / "ops.py").write_text("@triton.jit\n@other\ndef k_c(x_ptr):\n    pass\n")
    (tmp_path / "_build").mkdir()
    (tmp_path / "_build" / "copy.cu").write_text("__global__ void stale(int x)")
    assert port_kernel_names(tmp_path) == ["k_a", "k_b", "k_c"]

"""The harness end to end on the CPU at the rehearsal shapes: it loads no
JAX, refuses to measure without a card, and its check fails the control
and every fault the timed path can have."""

import json
import subprocess
import sys
import types

import pytest
import torch

from portbench import check, control, run, serve, traffic
from stepth_tpu_torch.match import fused_refine

CPU = torch.device("cpu")


def spec(cell, traffic_name=None):
    """A cell of BENCHMARK.json; or, with ``traffic_name``, the cell's
    configuration under another traffic file (the video entry's)."""
    out = run.resolve(cell)
    if traffic_name is not None:
        out["traffic"] = traffic.load(traffic_name)
    return out


def rehearse(cell, *extra):
    return subprocess.run(
        [sys.executable, str(run.HERE / "run.py"), "--workload", cell, "--seed", "4000000007",
         "--seconds", "0.3", "--rehearse", *extra],
        capture_output=True, text=True, timeout=600, cwd=run.ROOT)


@pytest.mark.parametrize("cell,trace", [("kitti2015-sgm", "1"), ("hd1080-prod-keyframe", "0")])
def test_rehearsal_is_correct_and_loads_no_jax(cell, trace):
    p = rehearse(cell, "--trace", trace)
    assert p.returncode == 0, p.stderr[-2000:]  # 3: a forbidden module was loaded
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["rehearsal"] and out["correct"] and "metrics" not in out and "device" not in out
    assert p.stderr.strip().splitlines()[-2:] == ["check disp_px 0 limit 0",
                                                  "check valid_px 0 limit 0"]


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: this run would measure")
    p = subprocess.run([sys.executable, str(run.HERE / "run.py"), "--workload", "kitti2015-sgm",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300, cwd=run.ROOT)
    assert p.returncode == 2 and p.stdout == ""


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "stepth_tpu_torch_extra", types.ModuleType("x"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "stepth_tpu.match", types.ModuleType("y"))
    assert run.forbidden_modules() == ["jax", "stepth_tpu"]


def _altered(entry):
    def broken(ls, rs):
        out = entry(ls, rs)
        d, v = out[-1]
        d = d.clone()
        d[d.shape[0] // 2, d.shape[1] // 2] += 0.25
        return out[:-1] + [(d, v)]
    return broken


def _half_left_out(entry):
    def broken(ls, rs):
        half = ls.shape[0] // 2
        out = entry(ls[:half], rs[:half])
        return out + out[: ls.shape[0] - half]
    return broken


def _state_unchanged(model, traffic):
    """Seeded frames refine around the keyframe's disparity, never the
    previous frame's."""
    def broken(ls, rs):
        key = model(ls[0], rs[0])
        out = [(key.disparity, key.valid)]
        for t in range(1, ls.shape[0]):
            r = fused_refine.seeded_frame(fused_refine.FUSED, ls[t], rs[t], key.disparity,
                                          model.match, model.pyramid, lr_check=True)
            out.append((r.disparity, r.valid))
        return out
    return broken


FAULTS = [("hd1080-prod-keyframe", None, "altered"), ("kitti2015-sgm", None, "altered"),
          ("hd1080-prod-keyframe", "hd1080-prod-seeded", "altered"),
          ("hd1080-prod-keyframe", "hd1080-prod-seeded", "half"),
          ("hd1080-prod-keyframe", "hd1080-prod-seeded", "state")]


@pytest.mark.parametrize("cell,traffic_name,fault", FAULTS)
def test_the_check_fails_a_broken_timed_path(monkeypatch, cell, traffic_name, fault):
    entry_of = serve.entry_of

    def broken_entry(model, traffic):
        if fault == "state":
            return _state_unchanged(model, traffic)
        entry = entry_of(model, traffic)
        return _altered(entry) if fault == "altered" else _half_left_out(entry)

    monkeypatch.setattr(serve, "entry_of", broken_entry)
    res = run.serve_cell(spec(cell, traffic_name), 123456789012, 0.2, False, CPU)
    assert not check.verdict(res["numbers"]), res["numbers"]
    assert res["numbers"]["disp_px"] > 0


@pytest.mark.parametrize("cell", ["hd1080-prod-keyframe", "kitti2015-sgm"])
def test_the_control_fails_the_check(cell):
    rows = control.readings(cell, [21, 22, 2 ** 32 + 3], CPU)
    assert all(not r["correct"] and r["disp_px"] > 0 for r in rows), rows


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["hd1080-prod-keyframe", "kitti2015-sgm"])
def test_the_control_fails_the_check_at_the_cells_size(cuda, cell):
    rows = control.readings(cell, [31, 32, 33], cuda)
    assert all(not r["correct"] and r["disp_px"] > 0 for r in rows), rows

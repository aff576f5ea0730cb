"""The port's benchmark: one cell of ``BENCHMARK.json`` on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A run resolves the cell, loads its configuration (``configs/``) and its
traffic (``traffic/``) by name, makes the frame pool from the seed, builds
the ``stepth_tpu_torch`` model the configuration names (the kernels load
from the program's own build cache in the checkout, built on the first
run), warms up on the cell's shapes, and serves the stream for
``--seconds`` (``serve.py``). With ``--trace 1`` it then profiles
``trace_calls`` more calls. After the window it recomputes a sample of the
served calls, drawn from the seed, with the plain reference
(``reference/``) and compares every pixel (``check.py``). It prints the
compared numbers beside their limits as the last lines of standard error,
and as the last line of standard output one JSON object: ``correct``,
``attempted``, ``failed``, the cell's metrics (``--trace 0``: end to end;
``--trace 1``: per layer; each read by ``metrics/<name>.py``), ``device``,
``breakdown`` with ``--trace 1``, ``notes`` where a reader left one
(the kernels the roofline's basis and the trace count differently), and
``check``.

Without a CUDA device, or with fewer than the cell asks for, it exits 2
and prints no result; if JAX or the JAX package was loaded, it exits 3.
``--rehearse`` runs the same loop and check on the CPU at the
configuration's ``rehearsal_shape`` through the kernels' plain versions,
and prints no metric and no device.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import pathlib
import sys
import tempfile
import time

_T0 = time.perf_counter()
HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# every build and kernel cache the run might make, at fixed paths in the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / ".cache" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / ".cache" / "triton")
os.environ["USE_FLAX"] = "0"

FORBIDDEN = ("jax", "jaxlib", "flax", "stepth_tpu")
WARMUP_CALLS = 2
PROGRAM = "stepth_tpu_torch"


def process_age_s() -> float:
    """Seconds since this process started (``/proc``), or since this module
    started where there is no ``/proc``."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T0


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (whole names: the program's own name only begins with one)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def resolve(name: str) -> dict:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration, its
    traffic and its metrics by kind."""
    from portbench import traffic as traffic_mod

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; one of {sorted(cells)}")
    cell = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((ROOT / entry["file"]).read_text())
    traffic = traffic_mod.load(cell["traffic"])

    def mine(metrics):
        return [m for m in metrics if "workloads" not in m or name in m["workloads"]]

    return {"cell": cell, "config": config, "traffic": traffic,
            "end_to_end": mine(bench["end_to_end"]), "per_layer": mine(bench["per_layer"])}


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{metric}",
                                                  HERE / "metrics" / f"{metric}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def build_model(model_cfg: dict):
    from stepth_tpu_torch.config import from_dict
    from stepth_tpu_torch.models.stereo import StereoModel

    return from_dict(StereoModel, model_cfg)


def recompute(ref, config, traffic, pool, items, device, precision="f32", record=None):
    """The reference's outputs for the served call over ``items``."""
    import torch

    from portbench import serve

    lefts, rights = serve.host_frames(pool, items)
    ls = torch.as_tensor(lefts, device=device).to(torch.float32)
    rs = torch.as_tensor(rights, device=device).to(torch.float32)
    outs = ref.run_call(ls, rs, config["model"], traffic, precision, record)
    return [(d.cpu().numpy(), v.cpu().numpy()) for d, v in outs]


def serve_cell(spec: dict, seed: int, seconds: float, trace: bool, device) -> dict:
    """Set up, serve the window, trace, check. Returns the run's result:
    ``run`` (a ``record.Run``), ``numbers`` (the check), ``peak``,
    ``attempted``, ``failed`` and ``forbidden``."""
    import torch

    from portbench import check, record, serve, traffic as traffic_mod
    from portbench.trace import Trace, port_kernel_names
    from stepth_tpu_torch.core.loader import PrefetchLoader

    config, traffic = spec["config"], spec["traffic"]
    shape = config["shape"] if device.type == "cuda" else config["rehearsal_shape"]
    model = build_model(config["model"])
    pool = traffic_mod.make_pool(traffic, shape, seed)
    ref = importlib.import_module(f"portbench.reference.{config['reference']}")
    served = serve.Served(PrefetchLoader, pool, serve.entry_of(model, traffic),
                          traffic["chunk"], device)
    try:
        for _ in range(WARMUP_CALLS):
            served.call()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        setup_s = process_age_s()
        kept = check.Reservoir(traffic["check_calls"], seed)
        calls = []
        t_open = time.perf_counter()
        while True:
            c = served.call()
            c["at"] = time.perf_counter() - t_open
            kept.offer({"items": c["items"], "outs": c.pop("outs")})
            calls.append(c)
            if time.perf_counter() - t_open >= seconds:
                break
        window_s = time.perf_counter() - t_open
        forbidden = forbidden_modules()
        run = record.Run(setup_s=setup_s, window_s=window_s, chunk=traffic["chunk"],
                         calls=calls)
        traced = []
        if trace:
            traced = traced_stretch(served, traffic["trace_calls"], device)
    finally:
        served.close()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del model, served
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    got, want = [], []
    for k in kept.items:
        got += k["outs"]
        want += recompute(ref, config, traffic, pool, k["items"], device)
    if trace:
        launches = []
        for c in traced["calls"]:
            rec = []
            got += c["outs"]
            want += recompute(ref, config, traffic, pool, c["items"], device, record=rec)
            launches += [launch for frame in rec for launch in frame]
        names = port_kernel_names(ROOT / PROGRAM)
        run.trace = Trace(traced["events"], names)
        run.traced_frames = len(traced["calls"]) * traffic["chunk"]
        run.launches = launches
    numbers = check.mismatches(got, want)
    numbers["frames"] = len(got)
    return {"run": run, "numbers": numbers, "peak": peak, "attempted": run.frames,
            "failed": 0, "forbidden": forbidden, "check_s": time.perf_counter() - t_check}


def traced_stretch(served, n: int, device) -> dict:
    """``n`` calls under ``torch.profiler`` after one unrecorded warm-up
    step; their calls (with outputs) and the trace's events."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        calls = []
        with profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=n, repeat=1),
                     on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
            for i in range(n + 1):
                c = served.call(annotate=True)
                if i:
                    calls.append(c)
                prof.step()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return {"calls": calls, "events": events}


def metric_values(metrics, run) -> dict:
    out = {}
    for m in metrics:
        value = reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def check_lines(numbers: dict) -> list:
    from portbench.check import LIMITS

    return [f"check {k} {numbers[k]} limit {lim}" for k, lim in LIMITS.items()]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rehearse", action="store_true",
                   help="run on the CPU at the rehearsal shape; report no metric")
    args = p.parse_args(argv)
    spec = resolve(args.workload)

    import torch

    if args.rehearse:
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            print("no CUDA device: the benchmark measures the card only", file=sys.stderr)
            return 2
        if torch.cuda.device_count() < spec["cell"]["chips"]:
            print(f"{torch.cuda.device_count()} CUDA devices, the cell asks for "
                  f"{spec['cell']['chips']}", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)

    res = serve_cell(spec, args.seed, args.seconds, bool(args.trace), device)
    run, numbers = res["run"], res["numbers"]
    forbidden = sorted(set(res["forbidden"]) | set(forbidden_modules()))
    if forbidden:
        print(f"forbidden modules loaded: {', '.join(forbidden)}", file=sys.stderr)
        return 3
    from portbench import check, stats

    correct = check.verdict(numbers)
    calls_ms = [1e3 * c["call"] for c in run.calls]
    print(f"{args.workload}: {len(calls_ms)} calls, {run.frames} frames in "
          f"{run.window_s:.4f} s; call ms median {stats.percentile(calls_ms, 50):.4f}, "
          f"p95 {stats.percentile(calls_ms, 95):.4f}; set-up {run.setup_s:.4f} s; "
          f"{numbers['frames']} frames recomputed in {res['check_s']:.4f} s", file=sys.stderr)
    blocks = {}
    for c in run.calls:  # the call times through the window, 5 s at a time
        blocks.setdefault(int(c["at"] // 5), []).append(1e3 * c["call"])
    print("call ms median by 5 s of the window: " + ", ".join(
        f"{stats.percentile(v, 50):.2f} ({len(v)})" for _, v in sorted(blocks.items())),
        file=sys.stderr)
    check_out = {k: {"value": numbers[k], "limit": lim} for k, lim in check.LIMITS.items()}
    check_out["frames"] = numbers["frames"]
    metrics = spec["per_layer"] if args.trace else spec["end_to_end"]
    values = metric_values(metrics, run)
    if args.rehearse:  # the readers ran; a CPU run's numbers are no device metrics
        print("\n".join(check_lines(numbers)), file=sys.stderr)
        print(json.dumps({"rehearsal": True, "correct": correct, "attempted": res["attempted"],
                          "failed": res["failed"], "calls": len(run.calls),
                          "read": sorted(values), "check": check_out}))
        return 0 if correct else 1
    device_out = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                  "count": 1, "memory_peak_bytes": int(res["peak"])}
    out = {"correct": correct, "attempted": res["attempted"], "failed": res["failed"],
           "metrics": values, "device": device_out}
    if args.trace:
        device_out["busy_s"] = run.trace.busy_s()
        device_out["window_s"] = run.trace.window_s
        out["breakdown"] = {"device_ops": run.trace.device_ops(),
                            "idle_gaps": run.trace.idle_gaps()}
    if run.notes:
        out["notes"] = run.notes
    out["check"] = check_out
    for note in run.notes:
        print(note, file=sys.stderr)
    print("\n".join(check_lines(numbers)), file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

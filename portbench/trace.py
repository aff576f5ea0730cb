"""Reading a ``torch.profiler`` Chrome trace of the traced stretch.

The stretch is the span from the first ``portbench/call`` annotation's start
to the last one's end. The device is busy where a kernel, copy or fill ran
(their union); the port's own kernels are those whose name carries a
``__global__`` function of the program's CUDA or C++ sources or a
``triton.jit`` function of its Python; every other kernel is torch glue. An idle gap is named by the benchmark span the host was in
for most of it and the innermost torch op running when it began.
"""

from __future__ import annotations

import pathlib
import re
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
CALL_SPAN = "portbench/call"
_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")
_TRITON = re.compile(r"@triton\.jit\b[^\n]*\n(?:\s*@[^\n]*\n)*\s*def\s+(\w+)\s*\(")
_NATIVE = (".cu", ".cuh", ".cpp", ".cc", ".h", ".hpp")


def port_kernel_names(package: pathlib.Path) -> List[str]:
    """The program's kernels: the ``__global__`` functions of its CUDA and
    C++ sources and the ``triton.jit`` functions of its Python, anywhere in
    the package outside its build cache."""
    names = set()
    for path in sorted(package.rglob("*")):
        if "_build" in path.relative_to(package).parts or not path.is_file():
            continue
        if path.suffix in _NATIVE:
            names.update(_GLOBAL.findall(path.read_text(errors="replace")))
        elif path.suffix == ".py":
            names.update(_TRITON.findall(path.read_text(errors="replace")))
    return sorted(names)


class Trace:
    """The events of one traced stretch."""

    def __init__(self, events: List[dict], kernel_names: Iterable[str]):
        self.events = [e for e in events if e.get("ph") == "X" and "dur" in e]
        calls = [e for e in self.events if e.get("name") == CALL_SPAN
                 and e.get("cat") == "user_annotation"]
        if not calls:
            raise ValueError("trace: no benchmark call span")
        self.start = min(e["ts"] for e in calls)
        self.end = max(e["ts"] + e["dur"] for e in calls)
        self.calls = len(calls)
        self.device = sorted((e for e in self.events if e.get("cat") in DEVICE_CATS
                              and e["ts"] < self.end and e["ts"] + e["dur"] > self.start),
                             key=lambda e: e["ts"])
        pattern = "|".join(re.escape(n) for n in sorted(kernel_names, key=len, reverse=True))
        self._port = re.compile(rf"\b({pattern})\b") if pattern else None
        self.spans = sorted((e for e in self.events if e.get("cat") == "user_annotation"
                             and e["name"].startswith("portbench/")
                             and e["name"] != CALL_SPAN), key=lambda e: e["ts"])
        self.ops = [e for e in self.events if e.get("cat") == "cpu_op"]

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    def port_kernel(self, event: dict) -> Optional[str]:
        """The port's kernel an event ran, or None."""
        if event.get("cat") != "kernel" or self._port is None:
            return None
        m = self._port.search(event["name"])
        return m.group(1) if m else None

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of device activity, clipped to the stretch (µs)."""
        out: List[List[float]] = []
        for e in self.device:
            s, t = max(e["ts"], self.start), min(e["ts"] + e["dur"], self.end)
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], t)
            else:
                out.append([s, t])
        return [(s, t) for s, t in out]

    def busy_s(self) -> float:
        return sum(t - s for s, t in self.busy_intervals()) / 1e6

    def kernel_seconds(self) -> Tuple[Dict[str, List[float]], float]:
        """Durations (s) of the port's kernels by name, and the summed
        seconds of every other kernel (glue)."""
        port: Dict[str, List[float]] = defaultdict(list)
        glue = 0.0
        for e in self.device:
            if e.get("cat") != "kernel":
                continue
            name = self.port_kernel(e)
            if name is None:
                glue += e["dur"] / 1e6
            else:
                port[name].append(e["dur"] / 1e6)
        return dict(port), glue

    def device_ops(self, top: int = 10) -> List[list]:
        """The device operations that took most time: ``[name, seconds]``,
        torch's kernel names cut to their first 160 characters."""
        total: Dict[str, float] = defaultdict(float)
        for e in self.device:
            name = self.port_kernel(e) or e["name"][:160]
            total[name] += e["dur"] / 1e6
        return [[n, s] for n, s in sorted(total.items(), key=lambda kv: -kv[1])[:top]]

    def _host_at(self, a: float, b: float) -> str:
        """The benchmark span covering most of ``[a, b)`` and the innermost
        torch op running at ``a``."""
        best, cover = "outside spans", 0.0
        for e in self.spans:
            ov = min(b, e["ts"] + e["dur"]) - max(a, e["ts"])
            if ov > cover:
                best, cover = e["name"].split("/", 1)[1], ov
        inner = None
        for e in self.ops:
            if e["ts"] <= a < e["ts"] + e["dur"] and (inner is None or e["dur"] < inner["dur"]):
                inner = e
        return best if inner is None else f"{best}: {inner['name']}"

    def idle_gaps(self, top: int = 10) -> List[list]:
        """The longest gaps between device activity inside the stretch,
        ``[what the host was doing, seconds]``."""
        gaps, prev = [], self.start
        for s, t in self.busy_intervals() + [(self.end, self.end)]:
            if s > prev:
                gaps.append((s - prev, prev, s))
            prev = max(prev, t)
        gaps.sort(reverse=True)
        return [[self._host_at(a, b), d / 1e6] for d, a, b in gaps[:top]]

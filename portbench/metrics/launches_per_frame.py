"""Kernel launches, copies and fills a frame that the serving thread issues
inside the program's own ``stepth/call`` spans: the ``cuda_runtime`` and
``cuda_driver`` events that start inside one, on its thread, and carry the
correlation id of a kernel, copy or fill of the trace; over the traced
frames. The loader's copies are issued on its worker threads and do not
count."""

import bisect
from collections import defaultdict

RUNTIME = ("cuda_runtime", "cuda_driver")
DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")


def spans(trace, name):
    """The traced stretch's ``user_annotation`` spans named ``name``."""
    return [e for e in trace.events if e.get("cat") == "user_annotation"
            and e["name"] == name and trace.start <= e["ts"] < trace.end]


def issued_inside(trace, name):
    """The runtime and driver events that put work on the device and start
    inside a span ``name`` on the span's own thread."""
    by_thread = defaultdict(list)
    for s in spans(trace, name):
        by_thread[(s.get("pid"), s.get("tid"))].append((s["ts"], s["ts"] + s["dur"]))
    for v in by_thread.values():
        v.sort()
    work = {e["args"]["correlation"] for e in trace.events
            if e.get("cat") in DEVICE and "correlation" in e.get("args", {})}
    out = []
    for e in trace.events:
        if e.get("cat") not in RUNTIME or e.get("args", {}).get("correlation") not in work:
            continue
        own = by_thread.get((e.get("pid"), e.get("tid")), [])
        i = bisect.bisect_right(own, (e["ts"], float("inf"))) - 1
        if i >= 0 and own[i][0] <= e["ts"] < own[i][1]:
            out.append(e)
    return out


def read(run):
    if run.trace is None or not run.traced_frames or not spans(run.trace, "stepth/call"):
        return None
    issued = issued_inside(run.trace, "stepth/call")
    return len(issued) / run.traced_frames if issued else None

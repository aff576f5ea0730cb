"""Device ms a frame of the census planes: every kernel whose launch (the
runtime event with its ``args.correlation``) starts inside one of the
program's ``stepth/census`` spans (``dense.census_pair``) on the span's
thread, over the traced frames."""

from portbench.metrics.launches_per_frame import issued_inside


def read(run):
    if run.trace is None or not run.traced_frames:
        return None
    launched = {e["args"]["correlation"] for e in issued_inside(run.trace, "stepth/census")}
    if not launched:
        return None
    us = sum(e["dur"] for e in run.trace.events
             if e.get("cat") == "kernel" and e.get("args", {}).get("correlation") in launched)
    return us / 1e3 / run.traced_frames

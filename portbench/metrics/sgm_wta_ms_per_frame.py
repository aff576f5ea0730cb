"""Device ms a frame of the SGM WTA from the stored path sum: every kernel
whose launch (the runtime event with its ``args.correlation``) starts
inside one of the program's ``stepth/sgm/wta`` spans (``fused_sgm``'s K9
and its K4) on the span's thread, over the traced frames. None where the
program opens no such span."""

from portbench.metrics.launches_per_frame import issued_inside


def device_ms_inside(run, name):
    """Device ms a traced frame of the kernels launched inside the spans
    ``name``, or None where none was."""
    if run.trace is None or not run.traced_frames:
        return None
    launched = {e["args"]["correlation"] for e in issued_inside(run.trace, name)}
    if not launched:
        return None
    us = sum(e["dur"] for e in run.trace.events
             if e.get("cat") == "kernel" and e.get("args", {}).get("correlation") in launched)
    return us / 1e3 / run.traced_frames


def read(run):
    return device_ms_inside(run, "stepth/sgm/wta")

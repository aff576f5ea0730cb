"""Host ms a frame in the program's refine plans: the summed durations of
its ``stepth/plan`` spans (``fused_refine.plan_level``) in the traced
stretch, over the traced frames. Under the profiler, which adds host time
to every torch op."""

from portbench.metrics.launches_per_frame import spans


def read(run):
    if run.trace is None or not run.traced_frames:
        return None
    plans = spans(run.trace, "stepth/plan")
    if not plans:
        return None
    return sum(e["dur"] for e in plans) / 1e3 / run.traced_frames

"""Frames whose disparity and validity reached host memory in the window,
over the window's wall time (host clock)."""

from portbench import stats


def read(run):
    return stats.rate(run.frames, run.window_s) if run.calls else None

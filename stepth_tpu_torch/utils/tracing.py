"""Tracing and profiling (twin of ``stepth_tpu/utils/tracing.py``).

Named spans in ``torch.profiler`` traces (``torch.profiler.record_function``
in place of ``jax.profiler.TraceAnnotation``), a wall-clock stage timer
that waits for the card's work when asked, and a device trace around a
region, written as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch

from stepth_tpu_torch.utils.debug import named_leaves


def _synchronize(tree) -> None:
    """Wait for the CUDA devices that hold tensors of ``tree``; CPU tensors
    are ready when the call that made them returns."""
    devices = {leaf.device for _, leaf in named_leaves(tree)
               if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)


class StageTimes:
    """Accumulates wall-clock time per named stage; one per pipeline
    instance (not thread-safe)."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        """Times a stage. The clock stops after the devices holding the
        tensors of ``block_on`` (a tree of tensors, read when the stage
        ends) are synchronised, so their work counts."""
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
        if block_on is not None:
            _synchronize(block_on)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"total_s": self.totals[k], "count": self.counts[k],
                "mean_s": self.totals[k] / max(self.counts[k], 1)}
            for k in sorted(self.totals)
        }


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """Profile the region (CPU activity, and CUDA activity where a card is
    present) when ``log_dir`` is given, and write its Chrome trace to
    ``log_dir/trace.json``; yields the ``torch.profiler.profile`` (``None``
    without ``log_dir``, when nothing is recorded)."""
    if log_dir is None:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Decorator: wrap a function in a named profiler span."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)

        return wrapped

    return deco

"""Tracing and profiling (twin of ``stepth_tpu/utils/tracing.py``).

Named spans in ``torch.profiler`` traces (``torch.profiler.record_function``
in place of ``jax.profiler.TraceAnnotation``), a wall-clock stage timer
that waits for the card's work when asked, a device trace around a region,
written as a Chrome trace, and process-wide counters.

A span costs one check of the profiler's state unless a ``torch.profiler``
records on the calling thread; then it is a ``record_function`` and lands
in the same trace as the CUDA kernels, copies and runtime calls, on one
clock. (Threads the profiler did not start from record nothing, so a span
on a worker thread is never seen.) The program's spans are named
``stepth/...`` and sit on its served path: ``stepth/call`` around a model
call, then ``coarse``, ``census``, ``plan``, ``refine``, ``post``,
``sgm/volume``, ``sgm/scan`` (``sgm/diagonal`` inside it on a diagonal
scan, ``sgm/deep`` inside that at D > 256), ``sgm/scan_wta``, ``sgm/wta``
and ``loader/take``.
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

_OFF = contextlib.nullcontext()  # shared: entering it does nothing
_profiling = torch._C._autograd._profiler_enabled
_counters: Dict[str, int] = defaultdict(int)


def span(name: str):
    """A context naming a region ``name`` in a ``torch.profiler`` trace
    while a profiler records on this thread; otherwise a shared no-op."""
    if _profiling():
        return torch.profiler.record_function(name)
    return _OFF


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the process-wide counter ``name``: a plain add, always
    on (one thread counts each name, so no lock)."""
    _counters[name] += n


def counters() -> Dict[str, int]:
    """A snapshot of every counter."""
    return dict(_counters)


def reset_counters() -> None:
    _counters.clear()


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
        with span(name):
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
    """Decorator: run a function inside :func:`span` ``(name)``."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return wrapped

    return deco

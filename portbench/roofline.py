"""The yardstick of the kernels' roofline: the card's peaks and the least
time a launch could take.

A launch's bound is the larger of its bytes over the peak bandwidth and its
f32 operations over the peak rate. Bytes count each input read once and
each output written once, whatever the kernel reads again; operations
count what these inputs need. The per-launch counts are written where the
reference runs the step the kernel stands for (``reference/*.py``), so they
follow the data (a refine plan's candidates) and not the kernel's code.
"""

from __future__ import annotations

PEAK_BYTES = 3.35e12  # NVIDIA H100 SXM HBM3, bytes/s (data sheet, 700 W)
PEAK_F32 = 67e12  # NVIDIA H100 SXM f32 operations/s outside the tensor cores


def bound_s(nbytes: float, ops: float) -> float:
    """Seconds the card needs at least for ``nbytes`` and ``ops``."""
    return max(nbytes / PEAK_BYTES, ops / PEAK_F32)


def cost_ops(cost: str, window: int, planes: int) -> int:
    """f32 operations per (pixel, d) of a cost and its separable box sums:
    sub + abs (or mul), or xor + popcount per census plane and the adds
    joining them; then per axis 4 adds for window 9 (two 3-sums joined) and
    ``window − 1`` for the others."""
    c = 3 * planes - 1 if cost == "census" else 2
    return c + 2 * (4 if window == 9 else window - 1)


def launch(kernel: str, nbytes: float, ops: float) -> dict:
    """One launch's record: the kernel's CUDA function name, its bytes and
    operations."""
    return {"kernel": kernel, "bytes": float(nbytes), "ops": float(ops)}

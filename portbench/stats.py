"""The arithmetic of the end-to-end metrics."""

from __future__ import annotations

import math
from typing import Sequence


def percentile(values: Sequence[float], p: float) -> float:
    """The nearest-rank ``p``-th percentile: the smallest value with at
    least ``p`` percent of the values at or below it."""
    if not values:
        raise ValueError("percentile of no values")
    ordered = sorted(values)
    k = max(1, math.ceil(p / 100.0 * len(ordered)))
    return ordered[k - 1]


def rate(count: int, seconds: float) -> float:
    """Items per second over a window."""
    if seconds <= 0:
        raise ValueError(f"window of {seconds} s")
    return count / seconds


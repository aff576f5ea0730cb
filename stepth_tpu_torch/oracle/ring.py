"""Exact expanding-ring search (NumPy oracle for reference src/helpers.rs:9-54;
twin of ``stepth_tpu/oracle/ring.py``).

Scan order per radius r (quirk Q8, docs/SEMANTICS.md §3):
row y+r left->right, row y-r left->right, column x+r top->bottom,
column x-r top->bottom. First match wins; out-of-bounds points are skipped; the
search stops after a ring with no in-bounds point (src/helpers.rs:49-51).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np


def _segment_first_match(
    add: np.ndarray, prec: np.ndarray, u: np.ndarray, ys, xs
) -> Tuple[bool, Optional[Tuple[int, int]]]:
    """First matching point along one ring segment given index arrays (may be
    scalars broadcast). Returns (any_in_bounds, (px, py) or None)."""
    h, w = add.shape[:2]
    ys = np.atleast_1d(np.asarray(ys, dtype=np.int64))
    xs = np.atleast_1d(np.asarray(xs, dtype=np.int64))
    ys, xs = np.broadcast_arrays(ys, xs)
    inb = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
    if not inb.any():
        return False, None
    yv = ys[inb]
    xv = xs[inb]
    cand = add[yv, xv].astype(np.int32)
    ok = (np.abs(cand - u[None, :]) < prec[None, :]).all(axis=1)
    hits = np.nonzero(ok)[0]
    if hits.size:
        i = int(hits[0])
        return True, (int(xv[i]), int(yv[i]))
    return True, None


def ring_search(
    value,
    add: np.ndarray,
    seed_x: int,
    seed_y: int,
    precision,
    max_radius: int = 255,
) -> Tuple[int, Optional[Tuple[int, int]]]:
    """Returns (distance, (px, py)) for the first match, or (0, None) when the
    search exhausts (reference unwrap_or at src/depth_image.rs:120).
    distance = trunc(sqrt(dx^2 + dy^2)) (src/helpers.rs:3-7)."""
    u = np.asarray(value, dtype=np.int32).reshape(3)
    prec = np.asarray(precision, dtype=np.int32).reshape(3)
    x, y = int(seed_x), int(seed_y)
    for r in range(max_radius):  # 0..max-1 inclusive (src/helpers.rs:26)
        span = np.arange(x - r, x + r + 1)
        vspan = np.arange(y - r, y + r + 1)
        segments = (
            (y + r, span),  # row y+r
            (y - r, span),  # row y-r
            (vspan, x + r),  # col x+r
            (vspan, x - r),  # col x-r
        )
        still = False
        for ys, xs in segments:
            inb, hit = _segment_first_match(add, prec, u, ys, xs)
            still = still or inb
            if hit is not None:
                px, py = hit
                d = math.isqrt((x - px) ** 2 + (y - py) ** 2)
                return d, (px, py)
        if not still:
            break
    return 0, None

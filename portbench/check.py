"""What decides ``correct``: the served outputs, held bit for bit against
the reference's.

During the window a reservoir keeps ``k`` calls drawn from the seed,
uniformly over every call the window made, with the host arrays the loop
delivered. After the window the reference recomputes each kept call from
the same host frames, and every pixel of every frame is compared: the
disparity by its bits (NaN equal to NaN), the validity mask exactly. The
program and the reference follow the same arithmetic in the same order,
so any differing pixel is a fault; each limit is 0.
"""

from __future__ import annotations

import random
from typing import List, Sequence, Tuple

import numpy as np

LIMITS = {"disp_px": 0, "valid_px": 0}


class Reservoir:
    """``k`` items drawn uniformly from a stream of unknown length
    (Algorithm R) with a generator seeded from the run's seed."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed)
        self.items: List = []
        self.seen = 0

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
            return
        j = self.rng.randrange(self.seen)
        if j < self.k:
            self.items[j] = item


def mismatches(got: Sequence[Tuple[np.ndarray, np.ndarray]],
               want: Sequence[Tuple[np.ndarray, np.ndarray]]) -> dict:
    """Pixels whose disparity bits or validity differ, over all frames."""
    if len(got) != len(want):
        raise ValueError(f"{len(got)} frames served against {len(want)} recomputed")
    disp = valid = 0
    for (gd, gv), (wd, wv) in zip(got, want):
        if gd.shape != wd.shape or gv.shape != wv.shape:
            disp += wd.size
            valid += wv.size
            continue
        same = (gd.view(np.int32) == wd.view(np.int32)) | (np.isnan(gd) & np.isnan(wd))
        disp += int((~same).sum())
        valid += int((gv.astype(bool) != wv.astype(bool)).sum())
    return {"disp_px": disp, "valid_px": valid}


def verdict(numbers: dict) -> bool:
    """Every number at or under its limit."""
    return all(numbers[k] <= lim for k, lim in LIMITS.items())

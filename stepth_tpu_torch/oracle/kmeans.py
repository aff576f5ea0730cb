"""NumPy oracle for ``depth_split`` (reference src/depth_image.rs:162-218;
twin of ``stepth_tpu/oracle/kmeans.py``), independent of the torch
implementation in ``ops.kmeans``; the same normative rules
(docs/SEMANTICS.md §7)."""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def depth_split_oracle(depth, zones: int) -> List[Tuple[Optional[int], Optional[int]]]:
    if zones < 2:
        return [(None, None)]
    d = np.asarray(depth, dtype=np.uint8).ravel()
    hist = np.bincount(d, minlength=256).astype(np.int64)
    img_min, img_max = int(d.min()), int(d.max())
    if img_min == img_max:
        return [(img_min, img_max)]
    step = max((img_max - img_min) // (zones - 1) - 1, 1)  # quirk Q5 guard
    centers = sorted(set(range(img_min, img_max, step)))
    bins = np.arange(256, dtype=np.int64)
    for _ in range(300):
        c = np.asarray(centers, dtype=np.int64)
        dist = np.abs(bins[:, None] - c[None, :])
        assign = np.argmin(dist, axis=1)  # first minimum = smaller center on ties
        new = []
        for k in range(len(c)):
            sel = assign == k
            cnt = hist[sel].sum()
            s = (hist[sel] * bins[sel]).sum()
            new.append(int(s // max(cnt, 1)))  # empty -> 0 (reference :187)
        new = sorted(set(new))
        if new == centers:
            break
        centers = new
    c = np.asarray(centers, dtype=np.int64)
    dist = np.abs(bins[:, None] - c[None, :])
    assign = np.argmin(dist, axis=1)
    out: List[Tuple[Optional[int], Optional[int]]] = []
    for k in range(len(c)):
        members = bins[(assign == k) & (hist > 0)]
        if members.size == 0:
            out.append((None, None))
        else:
            out.append((int(members.min()), int(members.max())))
    return out

"""Normative disage-equivalent subdivision (NumPy oracle; twin of
``stepth_tpu/oracle/subdivision.py``). Its static-geometry helpers
(:func:`axis_boundaries`, :func:`split_axes`, :func:`level_geometry`,
:func:`default_max_splits`) are also ``match.parity``'s.

The reference's subdivision engine (disage) is an unvendored submodule; this module
is the normative reconstruction fixed in docs/SEMANTICS.md §2, inferred from the
call site at reference src/depth_image.rs:101-109:

* binary halvings, axis alternating by level (level 0 = the longer axis);
* floor-midpoint halving => level-k boundaries along an axis of length n are
  ``floor(i * n / 2^k)`` (empty intervals dropped; 1-px intervals are leaves);
* a pixel's leaf is its block at the smallest level d in [min_splits, max_splits]
  that is homogeneous (per-channel max-min <= precision for all channels), else its
  level-``max_splits`` block; ``min_splits`` splits are forced;
* leaf value = per-channel floor mean (MeanBrightnessHasher);
* the match seed is quirk Q1: ``((x0 + bw) // 2, (y0 + bh) // 2)``
  (reference src/depth_image.rs:114-117) — the midpoint of origin->(x0+bw), biased
  toward the origin, NOT the block center.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np


def axis_boundaries(n: int, k: int) -> np.ndarray:
    """Distinct level-k boundaries of [0, n): unique floor(i*n/2^k), i=0..2^k.
    Returned with the terminal n; len-1 = number of blocks along the axis."""
    if k >= 63:
        k = 63
    i = np.arange((1 << k) + 1, dtype=np.uint64)
    b = (i * np.uint64(n)) >> np.uint64(k)
    return np.unique(b).astype(np.int64)


def split_axes(d: int, width_first: bool) -> Tuple[int, int]:
    """(k_rows, k_cols): how many of the first d splits hit each axis."""
    if width_first:
        return d // 2, (d + 1) // 2
    return (d + 1) // 2, d // 2


def level_geometry(height: int, width: int, d: int, width_first: bool):
    """Boundaries and per-pixel block indices for level d."""
    kr, kc = split_axes(d, width_first)
    rb = axis_boundaries(height, kr)
    cb = axis_boundaries(width, kc)
    row_ids = np.searchsorted(rb, np.arange(height), side="right") - 1
    col_ids = np.searchsorted(cb, np.arange(width), side="right") - 1
    return rb, cb, row_ids, col_ids


@dataclasses.dataclass
class Subdivision:
    """Per-pixel leaf-block description (all arrays [H, W])."""

    value: np.ndarray  # u8[H, W, 3] — leaf mean color
    seed_x: np.ndarray  # i32 — quirk-Q1 seed column
    seed_y: np.ndarray  # i32 — quirk-Q1 seed row
    level: np.ndarray  # i32 — chosen level per pixel
    x0: np.ndarray
    y0: np.ndarray
    bw: np.ndarray
    bh: np.ndarray


def default_max_splits(height: int, width: int) -> int:
    """reference src/depth_image.rs:101-103."""
    return int(math.ceil(math.log2(float(height * width))))


def subdivide(
    rgb: np.ndarray,
    precision,
    min_splits: int = 16,
    max_splits: int | None = None,
) -> Subdivision:
    rgb = np.asarray(rgb, dtype=np.uint8)
    h, w, _ = rgb.shape
    if max_splits is None:
        max_splits = default_max_splits(h, w)
    eff_min = min(min_splits, max_splits)  # normative clamp (docs/SEMANTICS.md §2)
    width_first = w >= h
    prec = np.asarray(precision, dtype=np.int32).reshape(3)

    img = rgb.astype(np.int32)
    # integral image for exact block means
    integ = np.zeros((h + 1, w + 1, 3), dtype=np.int64)
    integ[1:, 1:] = img.astype(np.int64).cumsum(axis=0).cumsum(axis=1)

    level = np.full((h, w), -1, dtype=np.int32)
    geo = {}
    for d in range(eff_min, max_splits + 1):
        rb, cb, row_ids, col_ids = level_geometry(h, w, d, width_first)
        geo[d] = (rb, cb, row_ids, col_ids)
        # per-block per-channel min/max via reduceat over distinct boundaries
        bmin = np.minimum.reduceat(img, rb[:-1], axis=0)
        bmin = np.minimum.reduceat(bmin, cb[:-1], axis=1)
        bmax = np.maximum.reduceat(img, rb[:-1], axis=0)
        bmax = np.maximum.reduceat(bmax, cb[:-1], axis=1)
        homog = ((bmax - bmin) <= prec).all(axis=-1)  # checker: any channel over -> split
        hpix = homog[row_ids][:, col_ids]
        newly = (level < 0) & (hpix | (d == max_splits))
        level[newly] = d

    value = np.zeros((h, w, 3), dtype=np.uint8)
    seed_x = np.zeros((h, w), dtype=np.int32)
    seed_y = np.zeros((h, w), dtype=np.int32)
    x0a = np.zeros((h, w), dtype=np.int32)
    y0a = np.zeros((h, w), dtype=np.int32)
    bwa = np.zeros((h, w), dtype=np.int32)
    bha = np.zeros((h, w), dtype=np.int32)
    for d in range(eff_min, max_splits + 1):
        sel = level == d
        if not sel.any():
            continue
        rb, cb, row_ids, col_ids = geo[d]
        y0 = rb[row_ids][:, None] * np.ones((1, w), dtype=np.int64)
        y1 = rb[row_ids + 1][:, None] * np.ones((1, w), dtype=np.int64)
        x0 = np.ones((h, 1), dtype=np.int64) * cb[col_ids][None, :]
        x1 = np.ones((h, 1), dtype=np.int64) * cb[col_ids + 1][None, :]
        area = (y1 - y0) * (x1 - x0)
        s = (
            integ[y1, x1]
            - integ[y0, x1]
            - integ[y1, x0]
            + integ[y0, x0]
        )
        mean = (s // area[..., None]).astype(np.uint8)
        bw = (x1 - x0).astype(np.int32)
        bh = (y1 - y0).astype(np.int32)
        value[sel] = mean[sel]
        x0a[sel] = x0.astype(np.int32)[sel]
        y0a[sel] = y0.astype(np.int32)[sel]
        bwa[sel] = bw[sel]
        bha[sel] = bh[sel]
        # quirk Q1 seed (reference src/depth_image.rs:114-117)
        seed_x[sel] = ((x0 + bw) // 2).astype(np.int32)[sel]
        seed_y[sel] = ((y0 + bh) // 2).astype(np.int32)[sel]

    return Subdivision(
        value=value, seed_x=seed_x, seed_y=seed_y, level=level,
        x0=x0a, y0=y0a, bw=bwa, bh=bha,
    )

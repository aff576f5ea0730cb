"""End-to-end NumPy oracle of the reference depth pipeline
(reference src/depth_image.rs:91-136) and the foreground flow (:220-245,
src/mask_image.rs:205-213); twin of ``stepth_tpu/oracle/pipeline.py``.
Slow and exact: the parity anchor of ``match.parity`` and ``native``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from stepth_tpu_torch.oracle import ring as ring_oracle
from stepth_tpu_torch.oracle import subdivision as subdiv
from stepth_tpu_torch.oracle.resize import resample_exact_np


def raw_disparity_map(
    main_rgb: np.ndarray,
    add_rgb: np.ndarray,
    precision,
    min_splits: int = 16,
    max_splits: Optional[int] = None,
    max_radius: int = 255,
) -> np.ndarray:
    """Per-pixel matched-distance map BEFORE normalization/resize: each pixel
    carries its leaf block's ring-search distance truncated as u8 (quirk Q2,
    reference src/depth_image.rs:111-123). Identical for all pixels of a block, so
    the search runs once per unique (value, seed) key."""
    main_rgb = np.asarray(main_rgb, dtype=np.uint8)
    add_rgb = np.asarray(add_rgb, dtype=np.uint8)
    s = subdiv.subdivide(main_rgb, precision, min_splits, max_splits)
    h, w, _ = main_rgb.shape

    v = s.value.astype(np.int64)
    key = (
        (s.seed_y.astype(np.int64) * w + s.seed_x.astype(np.int64)) * (1 << 24)
        + v[..., 0] * (1 << 16)
        + v[..., 1] * (1 << 8)
        + v[..., 2]
    )
    uniq, inverse = np.unique(key.ravel(), return_inverse=True)
    dists = np.zeros(uniq.shape[0], dtype=np.uint8)
    # representative pixel per unique block
    first_idx = np.zeros(uniq.shape[0], dtype=np.int64)
    seen = np.full(uniq.shape[0], False)
    flat_inv = inverse.ravel()
    for i, g in enumerate(flat_inv):
        if not seen[g]:
            seen[g] = True
            first_idx[g] = i
    sy = s.seed_y.ravel()
    sx = s.seed_x.ravel()
    val = s.value.reshape(-1, 3)
    for g in range(uniq.shape[0]):
        i = first_idx[g]
        d, _ = ring_oracle.ring_search(
            val[i], add_rgb, int(sx[i]), int(sy[i]), precision, max_radius
        )
        dists[g] = np.uint8(d & 0xFF)  # quirk Q2: u32 -> u8 wrap
    return dists[flat_inv].reshape(h, w)


def depth_from_additional_oracle(
    main_rgb: np.ndarray,
    add_rgb: np.ndarray,
    precision,
    min_splits: int = 16,
    max_splits: Optional[int] = None,
    max_radius: int = 255,
) -> np.ndarray:
    """Full pipeline: subdivision -> ring match -> max-normalize (quirk Q3 guarded:
    max == 0 yields all-zero instead of the reference's panic) -> collect -> luma ->
    Gaussian resize (reference src/depth_image.rs:124-135)."""
    raw = raw_disparity_map(
        main_rgb, add_rgb, precision, min_splits, max_splits, max_radius
    )
    m = int(raw.max())
    if m == 0:
        norm = np.zeros_like(raw)
    else:
        norm = ((raw.astype(np.uint64) * 255) // m).astype(np.uint8)
    h, w = norm.shape
    # collect() paints leaf values at full res (norm already is per-pixel); gray
    # [v,v,v] -> luma v exactly (docs/SEMANTICS.md §2); Gaussian resize at same
    # size still resamples (docs/SEMANTICS.md §4).
    return resample_exact_np(norm, h, w, "gaussian")


def foreground_oracle(image_rgba: np.ndarray, depth: np.ndarray) -> np.ndarray:
    """README flow (reference Readme.md:19-24): invert depth, k-means(2), slice the
    lowest cluster, zero the image outside the mask. Returns RGBA u8."""
    from stepth_tpu_torch.oracle.kmeans import depth_split_oracle

    inv = (255 - depth.astype(np.int32)).astype(np.uint8)
    lo, hi = depth_split_oracle(inv, 2)[0]
    lo = 0 if lo is None else lo
    hi = 255 if hi is None else hi
    mask = np.where((inv >= lo) & (inv <= hi), 255, 0).astype(np.uint8)
    out = np.asarray(image_rgba, dtype=np.uint8).copy()
    out[mask == 0] = 0
    return out

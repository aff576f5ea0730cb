"""1-D k-means depth segmentation (twin of ``stepth_tpu/ops/kmeans.py``).

Depth is u8, so Lloyd's iteration runs exactly on a 256-bin histogram made
on the depth's device. Centres live in a fixed 256-slot ascending vector,
padded with a sentinel. The rules are the reference's: an assignment tie
goes to the smaller centre (the first minimum); the update is the floor
integer mean, 0 for an empty cluster; equal centres merge (sort, then drop
adjacent duplicates); the loop ends when the sorted, deduplicated vector
stops changing, or after 300 rounds; the initial step is at least 1 and a
constant plane is one degenerate cluster. Sums are int64 (the reference's
int32 would overflow past ~8.4 M pixels of depth 255).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from stepth_tpu_torch.match.dense import to_tensor

_SLOTS = 256
_SENTINEL = 1 << 20
_MAX_ITERS = 300


def _histogram(depth: torch.Tensor) -> torch.Tensor:
    return torch.bincount(depth.to(torch.uint8).reshape(-1).long(), minlength=256)


def _dedupe_sorted(centers: torch.Tensor) -> torch.Tensor:
    """Replace duplicates in an ascending sentinel-padded vector by the
    sentinel, then sort again (one copy of each value stays)."""
    prev = torch.cat([centers.new_full((1,), -1), centers[:-1]])
    return torch.sort(torch.where(centers != prev, centers, _SENTINEL)).values


def _assign(centers: torch.Tensor) -> torch.Tensor:
    """Index of each bin's nearest active centre (first minimum)."""
    bins = torch.arange(256, dtype=torch.int64, device=centers.device)
    dist = torch.abs(centers[None, :] - bins[:, None])
    dist = torch.where((centers < _SENTINEL)[None, :], dist, _SENTINEL)
    return torch.argmin(dist, dim=1)


def _lloyd_step(hist: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """One assignment and update round on the histogram."""
    bins = torch.arange(256, dtype=torch.int64, device=hist.device)
    onehot = torch.nn.functional.one_hot(_assign(centers), _SLOTS)  # [bins, slots]
    counts = (hist[:, None] * onehot).sum(0)
    sums = ((hist * bins)[:, None] * onehot).sum(0)
    means = torch.div(sums, torch.clamp(counts, min=1), rounding_mode="floor")
    new = torch.where(centers < _SENTINEL, means, _SENTINEL)
    # the means are not monotone in slot order (an emptied cluster maps to
    # 0), so sort before dropping adjacent duplicates
    return _dedupe_sorted(torch.sort(new).values)


def _run_lloyd(hist: torch.Tensor, init: torch.Tensor):
    prev = _dedupe_sorted(init)
    centers = _lloyd_step(hist, prev)
    it = 1
    while it < _MAX_ITERS and bool((centers != prev).any()):
        prev, centers = centers, _lloyd_step(hist, centers)
        it += 1
    # final assignment → per-cluster (min, max) over populated bins
    bins = torch.arange(256, dtype=torch.int64, device=hist.device)
    member = torch.nn.functional.one_hot(_assign(centers), _SLOTS).bool() & (hist > 0)[:, None]
    mins = torch.where(member, bins[:, None], 256).amin(0)
    maxs = torch.where(member, bins[:, None], -1).amax(0)
    return centers, mins, maxs


def depth_split(depth, zones: int) -> List[Tuple[Optional[int], Optional[int]]]:
    """Cluster the u8 depth plane into ``zones`` 1-D k-means clusters;
    returns (min, max) per final cluster in ascending centre order, (None,
    None) for a cluster left empty."""
    if zones < 2:
        return [(None, None)]
    depth = to_tensor(depth)
    hist = _histogram(depth)
    populated = np.nonzero(hist.cpu().numpy())[0]
    img_min, img_max = int(populated[0]), int(populated[-1])
    if img_min == img_max:
        return [(img_min, img_max)]
    step = max((img_max - img_min) // (zones - 1) - 1, 1)
    init = list(range(img_min, img_max, step))  # excludes img_max
    init_arr = np.full(_SLOTS, _SENTINEL, dtype=np.int64)
    init_arr[: len(init)] = init[:_SLOTS]
    centers, mins, maxs = _run_lloyd(hist, torch.as_tensor(init_arr, device=depth.device))
    centers, mins, maxs = (t.cpu().numpy() for t in (centers, mins, maxs))
    out: List[Tuple[Optional[int], Optional[int]]] = []
    for k in range(_SLOTS):
        if centers[k] >= _SENTINEL:
            break
        out.append((None, None) if mins[k] > 255 else (int(mins[k]), int(maxs[k])))
    return out

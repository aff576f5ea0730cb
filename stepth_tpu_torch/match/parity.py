"""The reference's depth-from-additional flow in torch (twin of
``stepth_tpu/match/parity.py:45-335``): subdivision, ring search, then
max-normalisation and a same-size Gaussian resample.

Every value is an integer, so the port equals the JAX package and the NumPy
oracle (``stepth_tpu/oracle/pipeline.py``) bit for bit:

* **subdivision** (:func:`subdivide`): levels ``d = min(min_splits,
  max_splits) … max_splits`` over static product grids (level-``k``
  boundaries along an axis of length ``n`` are ``floor(i·n/2^k)``, width
  first when ``w >= h``); per-block min, max and sum by ``scatter_reduce``
  over the level's row and column ids; a pixel's leaf is its block at the
  first homogeneous level (per channel ``max − min <= precision``), forced
  at ``max_splits``; the leaf value is the floor mean and the seed the
  quirk-Q1 ``((x0 + bw) // 2, (y0 + bh) // 2)``;
* **ring search** (:func:`match_distance`): a candidate matches when
  ``|cand − value| < precision`` on all three channels, and the first match
  in the scan order wins (rings outward; in a ring row ``+r``, row ``−r``,
  column ``+r``, column ``−r``, each swept upward, corners at their
  earliest visit). Phase A probes the whole square of radius
  ``phase_a_radius`` in key order, in chunks; phase B sweeps one whole ring
  per step over the leaves still unmatched that the ring can still reach
  (``r <= r_out``), one host sync a ring. Every pixel of a leaf carries the
  same ``(value, seed)``, so the search runs once per distinct leaf. The
  distance is ``isqrt(dy² + dx²)``, 0 without a match, wrapped to u8
  (quirk Q2);
* **normalise** (:func:`depth_from_additional`): ``raw·255 // max(raw)``,
  all zero where the max is 0 (quirk Q3), then
  ``ops.resize.resample_exact(…, "gaussian")``.

The static-geometry helpers (``axis_boundaries``, ``split_axes``,
``level_geometry``, ``default_max_splits``) are the port's NumPy oracle's
(``stepth_tpu_torch.oracle.subdivision``).
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from stepth_tpu_torch.match.dense import to_tensor
from stepth_tpu_torch.oracle.subdivision import (  # noqa: F401 (parity's static geometry)
    axis_boundaries, default_max_splits, level_geometry, split_axes,
)

# bytes a gather of candidates may hold at once (indices, packed colours,
# masks): phase A's offsets and phase B's leaves are chunked to it
_GATHER_BYTES = 256 << 20


class LeafMaps(NamedTuple):
    """Per-pixel leaf-block description (int32 tensors)."""

    value: torch.Tensor  # [H, W, 3]
    seed_x: torch.Tensor  # [H, W]
    seed_y: torch.Tensor  # [H, W]
    level: torch.Tensor  # [H, W]


def _sync(dev: torch.device) -> None:
    """Wait for the device's queued work (for the phase times)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _precision(precision, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(precision, np.int32).reshape(3), device=device)


def _block_reduce(img: torch.Tensor, rid: torch.Tensor, cid: torch.Tensor, nr: int, nc: int,
                  op: str) -> torch.Tensor:
    """[H, W, 3] → [nr, nc, 3]: ``op`` ("amin", "amax", "sum") over each
    block, rows then columns."""
    h, w, c = img.shape
    rows = torch.zeros((nr, w, c), dtype=img.dtype, device=img.device)
    rows = rows.scatter_reduce(0, rid[:, None, None].expand(h, w, c), img, op,
                               include_self=False)
    out = torch.zeros((nr, nc, c), dtype=img.dtype, device=img.device)
    return out.scatter_reduce(1, cid[None, :, None].expand(nr, w, c), rows, op,
                              include_self=False)


def subdivide(rgb, precision, min_splits: int = 16, max_splits: Optional[int] = None,
              device=None) -> LeafMaps:
    """Leaf maps of u8 RGB [H, W, 3] (a tensor keeps its device; an array goes
    to ``device``, the card by default)."""
    img = to_tensor(rgb, device).to(torch.int32)
    dev = img.device
    h, w = int(img.shape[0]), int(img.shape[1])
    if max_splits is None:
        max_splits = default_max_splits(h, w)
    eff_min = min(min_splits, max_splits)
    width_first = w >= h
    prec = _precision(precision, dev)

    level = torch.full((h, w), -1, dtype=torch.int32, device=dev)
    value = torch.zeros((h, w, 3), dtype=torch.int32, device=dev)
    seed_x = torch.zeros((h, w), dtype=torch.int32, device=dev)
    seed_y = torch.zeros((h, w), dtype=torch.int32, device=dev)
    for d in range(eff_min, max_splits + 1):
        rb, cb, row_ids, col_ids = level_geometry(h, w, d, width_first)
        nr, nc = len(rb) - 1, len(cb) - 1
        rid = torch.as_tensor(row_ids, device=dev)
        cid = torch.as_tensor(col_ids, device=dev)
        bmin = _block_reduce(img, rid, cid, nr, nc, "amin")
        bmax = _block_reduce(img, rid, cid, nr, nc, "amax")
        bsum = _block_reduce(img, rid, cid, nr, nc, "sum")
        homog = ((bmax - bmin) <= prec).all(dim=-1)
        rsz, csz = np.diff(rb), np.diff(cb)
        area = torch.as_tensor((rsz[:, None] * csz[None, :]).astype(np.int32), device=dev)
        bmean = torch.div(bsum, area[..., None], rounding_mode="floor")
        # quirk Q1 seeds, static per block: (x0 + bw) // 2, (y0 + bh) // 2
        sx_b = torch.as_tensor(((cb[:-1] + csz) // 2).astype(np.int32), device=dev)
        sy_b = torch.as_tensor(((rb[:-1] + rsz) // 2).astype(np.int32), device=dev)

        hpix = homog[rid][:, cid]
        newly = (level < 0) & (hpix | (d == max_splits))
        level = torch.where(newly, d, level)
        value = torch.where(newly[..., None], bmean[rid][:, cid], value)
        seed_x = torch.where(newly, sx_b[cid][None, :], seed_x)
        seed_y = torch.where(newly, sy_b[rid][:, None], seed_y)
    return LeafMaps(value=value, seed_x=seed_x, seed_y=seed_y, level=level)


def _ring_rank_np(dy: int, dx: int) -> int:
    """Scan-order rank of an offset within its Chebyshev ring (quirk Q8):
    row +r, row −r, column +r, column −r; within a segment, ascending.
    Corners take their earliest visit."""
    r = max(abs(dy), abs(dx))
    width = 2 * r + 1
    ranks = []
    if dy == r:
        ranks.append(0 * width + (dx + r))
    if dy == -r:
        ranks.append(1 * width + (dx + r))
    if dx == r:
        ranks.append(2 * width + (dy + r))
    if dx == -r:
        ranks.append(3 * width + (dy + r))
    return min(ranks)


def _phase_a_offsets(radius: int) -> Tuple[np.ndarray, np.ndarray]:
    """(dy, dx) of every offset with Chebyshev radius <= ``radius``, in scan
    order: by ring, then by rank in the ring."""
    offs = [(dy, dx) for dy in range(-radius, radius + 1) for dx in range(-radius, radius + 1)]
    offs.sort(key=lambda o: (max(abs(o[0]), abs(o[1])), _ring_rank_np(*o)))
    dys, dxs = zip(*offs)
    return np.asarray(dys, np.int64), np.asarray(dxs, np.int64)


def _ring_offsets(r: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dy, dx) of the ring's 4·(2r + 1) probes in scan order (key
    ``side·(2r + 1) + t``; corners appear twice, the later visit never
    wins)."""
    t = torch.arange(-r, r + 1, device=device)
    rr = torch.full_like(t, r)
    dy = torch.cat([rr, -rr, t, t])
    dx = torch.cat([t, t, rr, -rr])
    return dy, dx


def _pack_rgb(rgb: torch.Tensor) -> torch.Tensor:
    """u8-range int32 [..., 3] → one int32 per pixel (r << 16 | g << 8 | b)."""
    return (rgb[..., 0] << 16) | (rgb[..., 1] << 8) | rgb[..., 2]


def _first_match(cy, cx, val, dy, dx, add_packed, prec, ah, aw):
    """For leaves (cy, cx, val: [n], [n], [n, 3]) and probe offsets (dy, dx:
    [m], in scan order): whether any probe matches, and the first one that
    does ([n] bool, [n] index into the probes)."""
    py = cy[:, None] + dy[None, :]
    px = cx[:, None] + dx[None, :]
    inb = (py >= 0) & (py < ah) & (px >= 0) & (px < aw)
    cand = add_packed[py.clamp(0, ah - 1) * aw + px.clamp(0, aw - 1)]
    ok = inb
    for ch, shift in enumerate((16, 8, 0)):
        c = (cand >> shift) & 0xFF
        ok = ok & ((c - val[:, ch, None]).abs() < prec[ch])
    any_ok = ok.any(dim=1)
    return any_ok, ok.to(torch.uint8).argmax(dim=1)  # argmax: the first maximum


def _isqrt(d2: torch.Tensor) -> torch.Tensor:
    """Exact floor(sqrt) for int32 inputs < 2^20: f32 sqrt and one
    correction each way."""
    s = torch.sqrt(d2.to(torch.float32)).to(torch.int32)
    s = s - (s * s > d2).to(torch.int32)
    return s + ((s + 1) * (s + 1) <= d2).to(torch.int32)


def _leaves(leaf: LeafMaps):
    """The distinct (value, seed) leaves: per-leaf cy, cx, value and the
    pixel → leaf index."""
    h, w = leaf.seed_x.shape
    v = leaf.value.reshape(-1, 3).to(torch.int64)
    key = ((leaf.seed_y.reshape(-1).to(torch.int64) * w + leaf.seed_x.reshape(-1)) << 24) | (
        v[:, 0] << 16) | (v[:, 1] << 8) | v[:, 2]
    uniq, inverse = torch.unique(key, return_inverse=True)
    val = torch.stack([(uniq >> 16) & 0xFF, (uniq >> 8) & 0xFF, uniq & 0xFF], dim=1)
    pos = uniq >> 24
    return pos // w, pos % w, val.to(torch.int32), inverse


def match_distance(leaf: LeafMaps, add_rgb, precision, max_radius: int = 255,
                   phase_a_radius: int = 16, stats: Optional[dict] = None) -> torch.Tensor:
    """Raw per-pixel matched distance u8[H, W] (quirk Q2: wrapped to u8), on
    the leaf maps' device. ``stats``, when given, receives the seconds of
    phase A and phase B (synchronised), the rings phase B swept, the
    distinct leaves and the share of pixels matched."""
    dev = leaf.seed_x.device
    h, w = int(leaf.seed_x.shape[0]), int(leaf.seed_x.shape[1])
    add = to_tensor(add_rgb, dev).to(torch.int32)
    ah, aw = int(add.shape[0]), int(add.shape[1])
    add_packed = _pack_rgb(add).reshape(-1)
    prec = _precision(precision, dev)
    r_hi = max_radius - 1  # rings 0 … max_radius − 1
    ra = min(phase_a_radius, r_hi)

    t0 = time.perf_counter()
    cy, cx, val, inverse = _leaves(leaf)
    n = int(cy.shape[0])
    matched = torch.zeros(n, dtype=torch.bool, device=dev)
    best_dy = torch.zeros(n, dtype=torch.int32, device=dev)
    best_dx = torch.zeros(n, dtype=torch.int32, device=dev)
    per_probe = 24  # bytes a (leaf, probe) holds: two int64 coordinates, a colour, masks

    # phase A: the square of radius ra in scan order, in chunks of offsets;
    # a chunk's first match wins only for leaves no earlier chunk matched
    dys, dxs = _phase_a_offsets(ra)
    dys, dxs = torch.as_tensor(dys, device=dev), torch.as_tensor(dxs, device=dev)
    idx = torch.arange(n, device=dev)
    step = max(1, _GATHER_BYTES // (per_probe * max(n, 1)))
    for k0 in range(0, len(dys), step):
        if idx.numel() == 0:
            break
        dy, dx = dys[k0:k0 + step], dxs[k0:k0 + step]
        hit, first = _first_match(cy[idx], cx[idx], val[idx], dy, dx, add_packed, prec, ah, aw)
        won = idx[hit]
        matched[won] = True
        best_dy[won] = dy[first[hit]].to(torch.int32)
        best_dx[won] = dx[first[hit]].to(torch.int32)
        idx = idx[~hit]
    if stats is not None:
        _sync(dev)
        stats["phase_a_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # phase B: one ring per step over the unmatched leaves it can still reach
    r_out = torch.maximum(torch.maximum(cy, ah - 1 - cy), torch.maximum(cx, aw - 1 - cx))
    rings = 0
    for r in range(ra + 1, r_hi + 1):
        idx = idx[r_out[idx] >= r]  # one host sync a ring
        if idx.numel() == 0:
            break
        rings += 1
        dy, dx = _ring_offsets(r, dev)
        chunk = max(1, _GATHER_BYTES // (per_probe * dy.numel()))
        for j in range(0, idx.numel(), chunk):
            sub = idx[j:j + chunk]
            hit, first = _first_match(cy[sub], cx[sub], val[sub], dy, dx, add_packed, prec,
                                      ah, aw)
            # where() keeps every update on the device: no sync inside a ring
            matched[sub] = matched[sub] | hit
            best_dy[sub] = torch.where(hit, dy[first].to(torch.int32), best_dy[sub])
            best_dx[sub] = torch.where(hit, dx[first].to(torch.int32), best_dx[sub])
        idx = idx[~matched[idx]]
    if stats is not None:
        _sync(dev)
        stats.update(phase_b_s=time.perf_counter() - t0, rings=rings, leaves=n,
                     matched_share=float(matched[inverse].float().mean()))

    dist = torch.where(matched, _isqrt(best_dy * best_dy + best_dx * best_dx), 0)
    return (dist & 0xFF).to(torch.uint8)[inverse].reshape(h, w)  # quirk Q2


def normalize_and_resample(raw: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``raw·255 // max(raw)`` as u8 (all zero where the max is 0: quirk Q3),
    then the same-size Gaussian resample."""
    from stepth_tpu_torch.ops.resize import resample_exact

    raw = raw.to(torch.int32)
    m = int(raw.max())
    norm = (raw * 255 // m if m > 0 else torch.zeros_like(raw)).to(torch.uint8)
    return resample_exact(norm, h, w, "gaussian")


def depth_from_additional(main_rgb, add_rgb, precision, min_splits: int = 16,
                          max_splits: Optional[int] = None, max_radius: int = 255,
                          phase_a_radius: int = 16, device=None,
                          stats: Optional[dict] = None) -> torch.Tensor:
    """The full parity pipeline: depth u8[H, W], bit-equal to the reference's
    ``parity.depth_from_additional`` and ``depth_from_additional_oracle``.
    Tensors keep their device; arrays go to ``device``, the card by default.
    ``stats`` (a dict) receives the seconds of each phase (``subdivide_s``,
    ``phase_a_s``, ``phase_b_s``, ``normalize_s``; synchronised), the rings
    phase B swept, the distinct leaves and the share of pixels matched."""
    main = to_tensor(main_rgb, device)
    dev = main.device
    h, w = int(main.shape[0]), int(main.shape[1])
    t0 = time.perf_counter()
    leaf = subdivide(main, precision, min_splits=min_splits, max_splits=max_splits)
    if stats is not None:
        _sync(dev)
        stats["subdivide_s"] = time.perf_counter() - t0
    raw = match_distance(leaf, to_tensor(add_rgb, dev), precision, max_radius=max_radius,
                         phase_a_radius=phase_a_radius, stats=stats)
    t0 = time.perf_counter()
    out = normalize_and_resample(raw, h, w)
    if stats is not None:
        _sync(dev)
        stats["normalize_s"] = time.perf_counter() - t0
    return out

"""Pieces every plain path of the reference shares: grayscale, census
planes, the ordered box sums, the cost front, the running WTA and the
epilogue (LR check, scanline fill, 3×3 median network).

A frozen copy, in plain torch, of the semantics the program's kernels are
held to. It imports nothing of the program, so a later change there cannot
move it. Every sum is taken in the order the kernels take it, so on one
device the program and this reference agree bit for bit.

``quantize`` rounds aggregated costs to a lower precision: identity for
``"f32"``, a bfloat16 round trip for ``"bf16"`` (the control).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

BIG = 1e30

# the 19-comparator median-of-9 sorting network (Smith); pairs (lo, hi)
MEDIAN9_NET = (
    (1, 2), (4, 5), (7, 8),
    (0, 1), (3, 4), (6, 7),
    (1, 2), (4, 5), (7, 8),
    (0, 3), (5, 8), (4, 7),
    (3, 6), (1, 4), (2, 5),
    (4, 7), (4, 2), (6, 4),
    (4, 2),
)


def quantizer(precision: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """The rounding applied to every aggregated cost: none for ``f32``, a
    bfloat16 round trip for ``bf16``."""
    if precision == "f32":
        return lambda x: x
    if precision == "bf16":
        return lambda x: x.to(torch.bfloat16).to(torch.float32)
    raise ValueError(f"precision must be 'f32' or 'bf16', got {precision!r}")


def grayscale(rgb: torch.Tensor) -> torch.Tensor:
    """Rec.709 luma of f32 RGB [H, W, 3], as three products and two sums."""
    rgb = rgb[..., :3].to(torch.float32)
    return 0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]


def census_planes(gray: torch.Tensor, window: int) -> torch.Tensor:
    """Census descriptors of gray [..., H, W] as int32 planes [P, ..., H, W]:
    bit ``i`` of plane ``p`` is neighbour ``32·p + i`` in row-major ``(dy,
    dx)`` order without the centre, set where ``gray > neighbour``;
    neighbours outside the image are edge-replicated."""
    h, w = gray.shape[-2:]
    r = window // 2
    dev = gray.device
    rows = torch.arange(-r, h + r, device=dev).clamp(0, h - 1)
    cols = torch.arange(-r, w + r, device=dev).clamp(0, w - 1)
    padded = gray[..., rows, :][..., cols]
    offs = [(dy, dx) for dy in range(-r, r + 1) for dx in range(-r, r + 1) if dy or dx]
    i = torch.arange(32, dtype=torch.int32, device=dev)
    weight = torch.where(i < 31, torch.ones_like(i) << i.clamp(max=30),
                         torch.iinfo(torch.int32).min)
    wshape = (-1,) + (1,) * gray.ndim
    planes = []
    for p in range(0, len(offs), 32):
        acc = torch.zeros(gray.shape, dtype=torch.int32, device=dev)
        for g in range(p, min(p + 32, len(offs)), 8):
            group = offs[g: min(g + 8, p + 32, len(offs))]
            nbs = torch.stack([padded[..., dy + r: dy + r + h, dx + r: dx + r + w]
                               for dy, dx in group])
            wts = weight[g - p: g - p + len(group)].reshape(wshape)
            acc = acc + ((gray[None] > nbs) * wts).sum(0, dtype=torch.int32)
        planes.append(acc)
    return torch.stack(planes).contiguous()


def census_pair(left: torch.Tensor, right: torch.Tensor, window: int):
    """Census planes [P, H, W] of both views."""
    planes = census_planes(torch.stack([left, right]), window)
    return planes[:, 0].contiguous(), planes[:, 1].contiguous()


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 as int64 (a SWAR count on the widened value)."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def box_sum_ordered(x: torch.Tensor, win: int, dim: int) -> torch.Tensor:
    """Valid-mode box sum of ``2·(win//2) + 1`` taps along ``dim``: window 9
    as ``y(k) = (c(k) + c(k−1)) + c(k+1)``, ``z(k) = (y(k) + y(k−3)) +
    y(k+3)``; other windows left to right."""
    n = x.shape[dim]
    if win == 9:
        y = (x.narrow(dim, 1, n - 2) + x.narrow(dim, 0, n - 2)) + x.narrow(dim, 2, n - 2)
        m = n - 2
        return (y.narrow(dim, 3, m - 6) + y.narrow(dim, 0, m - 6)) + y.narrow(dim, 6, m - 6)
    taps = 2 * (win // 2) + 1
    out_n = n - taps + 1
    z = x.narrow(dim, 0, out_n)
    for j in range(1, taps):
        z = z + x.narrow(dim, j, out_n)
    return z


def pixel_cost(left, right_shifted, cost: str) -> torch.Tensor:
    """Per-pixel cost of gray values (SAD, SSD) or census planes (the
    Hamming distance summed over the planes, as f32)."""
    if cost == "census":
        return popcount32(left ^ right_shifted).sum(0).to(torch.float32)
    diff = left - right_shifted
    return diff * diff if cost == "ssd" else diff.abs()


def box_cost(lg, rg, planes, match: dict, d: int, q) -> torch.Tensor:
    """The zero-padded ``window``² box sum of the cost against the right view
    at ``x − d`` (column 0 where ``x − d < 0``), rounded by ``q``. f32[H, W]."""
    w = lg.shape[1]
    win = match["window"]
    r = win // 2
    xs = (torch.arange(w, device=lg.device) - d).clamp(min=0)
    if match["cost"] == "census":
        lc, rc = planes
        cost = pixel_cost(lc, rc[:, :, xs], "census")
    else:
        cost = pixel_cost(lg, rg[:, xs], match["cost"])
    padded = torch.nn.functional.pad(cost, (r, r, r, r))
    return q(box_sum_ordered(box_sum_ordered(padded, win, 0), win, 1))


class Wta:
    """The running first-minimum WTA over ascending ``d`` of f32[H, W] cost
    planes: strict ``<``, the neighbours of the best for the parabolic
    subpixel, and the right view ``costR(x, d) = cost(x + d, d)``."""

    def __init__(self, shape, device):
        def full(v, dtype=torch.float32):
            return torch.full(shape, v, dtype=dtype, device=device)

        self.best, self.cb, self.cp1, self.bestr = full(BIG), full(BIG), full(BIG), full(BIG)
        self.cm1, self.prev = full(0.0), full(0.0)
        self.bestd = self.bestrd = full(0, torch.int32)
        self.w = shape[1]

    def update(self, agg: torch.Tensor, d: int) -> None:
        upd = agg < self.best
        is_next = ~upd & (self.bestd == d - 1)
        self.cm1 = torch.where(upd, self.prev, self.cm1)
        self.cb = torch.where(upd, agg, self.cb)
        self.cp1 = torch.where(is_next, agg, self.cp1)
        self.best = torch.where(upd, agg, self.best)
        self.bestd = torch.where(upd, d, self.bestd)
        self.prev = agg
        aggr = torch.full_like(agg, BIG)
        if d < self.w:
            aggr[:, : self.w - d] = agg[:, d:]
        updr = aggr < self.bestr
        self.bestr = torch.where(updr, aggr, self.bestr)
        self.bestrd = torch.where(updr, d, self.bestrd)

    def result(self, D: int):
        """``(disp, disp_r)``, f32[H, W]."""
        denom = self.cm1 - 2.0 * self.cb + self.cp1
        delta = torch.where(denom.abs() > 1e-6, (self.cm1 - self.cp1) / (2.0 * denom), 0.0)
        delta = delta.clamp(-0.5, 0.5)
        interior = (self.bestd >= 1) & (self.bestd <= D - 2)
        bd = self.bestd.to(torch.float32)
        return torch.where(interior, bd + delta, bd), self.bestrd.to(torch.float32)


def lr_consistency(disp_l, disp_r, threshold: float, num_disparities: int) -> torch.Tensor:
    """``|dL(x) − dR(xr)| ≤ threshold`` with ``xr = clip(round(x − dL), 0,
    W−1)``; for ``xr ≥ 1`` the shift ``x − xr`` must lie in ``[0, D)``, for
    ``xr = 0`` ``x < D`` suffices."""
    h, w = disp_l.shape
    x = torch.arange(w, dtype=torch.float32, device=disp_l.device)[None, :]
    xr = torch.round(x - disp_l).clamp(0.0, float(w - 1))
    shift = x - xr
    in_range = torch.where(xr >= 1.0, (shift >= 0) & (shift < num_disparities),
                           x < num_disparities)
    dr_at = disp_r.gather(1, xr.to(torch.int64).clamp(0, w - 1))
    return in_range & ((disp_l - dr_at).abs() <= threshold)


def fill_invalid(disp: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Each invalid pixel takes the smaller of the nearest valid disparities
    on its scanline (0 where there is neither)."""
    h, w = disp.shape
    x = torch.arange(w, device=disp.device)[None, :].expand(h, w)
    li = torch.where(valid, x, -1).cummax(dim=1).values
    ri = torch.where(valid, x, w).flip(1).cummin(dim=1).values.flip(1)
    inf = float("inf")
    left = torch.where(li >= 0, disp.gather(1, li.clamp(min=0)), inf)
    right = torch.where(ri < w, disp.gather(1, ri.clamp(max=w - 1)), inf)
    fill = torch.minimum(left, right)
    fill = torch.where(torch.isfinite(fill), fill, 0.0)
    return torch.where(valid, disp, fill)


def median3(x: torch.Tensor) -> torch.Tensor:
    """3×3 median by the comparator network over the nine edge-replicated
    shifts."""
    h, w = x.shape
    rows = torch.arange(-1, h + 1, device=x.device).clamp(0, h - 1)
    cols = torch.arange(-1, w + 1, device=x.device).clamp(0, w - 1)
    padded = x[rows][:, cols]
    p = [padded[dy: dy + h, dx: dx + w] for dy in range(3) for dx in range(3)]
    for a, b in MEDIAN9_NET:
        p[a], p[b] = torch.minimum(p[a], p[b]), torch.maximum(p[a], p[b])
    return p[4]


def epilogue(disp, disp_r, threshold: Optional[float], num_disparities: int):
    """LR check, occlusion fill, median: ``(disparity, valid)``."""
    thr = 1.0 if threshold is None else float(threshold)
    valid = lr_consistency(disp, disp_r, thr, num_disparities)
    return median3(fill_invalid(disp, valid)), valid

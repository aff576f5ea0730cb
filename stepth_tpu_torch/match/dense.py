"""Dense rectified-stereo matcher in plain PyTorch (twin of
``stepth_tpu/match/dense.py``).

These are the reference semantics the fused kernels are held to: grayscale,
the [H, W, D] cost volume with an edge-replicated shifted right image, the
zero-padded box aggregation, winner-take-all with parabolic subpixel and
uniqueness, the 3×3 median and the u8 depth scaling. Census costs, the
right-view WTA, the LR check and the occlusion fill come with the census+LR
slice.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from stepth_tpu_torch.config import MatchConfig


class MatchResult(NamedTuple):
    """Disparity output of the dense matcher."""

    disparity: torch.Tensor  # f32[H, W]; -1 where invalid
    valid: torch.Tensor  # bool[H, W]
    cost: torch.Tensor  # f32[H, W] winning aggregated cost (diagnostics)


def to_tensor(x, device=None) -> torch.Tensor:
    """``x`` as a tensor. A tensor keeps its device (``device``, if given,
    must agree); an array needs an explicit ``device``, so that nothing lands
    on a default device by accident."""
    if isinstance(x, torch.Tensor):
        if device is not None and x.device != torch.device(device):
            raise ValueError(f"tensor on {x.device}, but device={device!r}")
        return x
    if device is None:
        raise ValueError("array input needs an explicit device= (e.g. 'cuda')")
    return torch.as_tensor(np.asarray(x), device=device)


def grayscale(rgb, device=None) -> torch.Tensor:
    """Rec.709 luma in f32, contiguous (a 2-D input is taken as gray
    already)."""
    rgb = to_tensor(rgb, device)
    if rgb.ndim == 2:
        return rgb.to(torch.float32).contiguous()
    rgb = rgb[..., :3].to(torch.float32)
    return 0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]


def _shift_right_image(img: torch.Tensor, num_disparities: int) -> torch.Tensor:
    """[H, W, D]: out[..., d] is the right image sampled at ``x − d``,
    edge-replicated where ``x − d < 0``."""
    w = img.shape[1]
    x = torch.arange(w, device=img.device)[:, None]
    d = torch.arange(num_disparities, device=img.device)[None, :]
    return img[:, (x - d).clamp(min=0)]


def cost_volume(left_gray, right_gray, cfg: MatchConfig) -> torch.Tensor:
    """Per-pixel matching cost f32[H, W, D] (smaller = better)."""
    if cfg.cost == "census":
        raise NotImplementedError(
            "census cost: ROADMAP slice 2 (census planes in K1/K2)"
        )
    if cfg.cost not in ("sad", "ssd"):
        raise NotImplementedError(f"cost {cfg.cost!r} unsupported")
    rs = _shift_right_image(right_gray, cfg.num_disparities)
    diff = left_gray[..., None] - rs
    if cfg.cost == "ssd":
        return diff * diff
    return diff.abs()


def box_aggregate(cost: torch.Tensor, window: int) -> torch.Tensor:
    """Box-window sum over the spatial dims of [H, W, ...] via two cumulative
    sums. Out-of-image contributions are zero (clipped windows are not
    renormalized)."""
    if window <= 1:
        return cost
    r = window // 2

    def axis_boxsum(x, axis):
        n = x.shape[axis]
        ii = torch.cumsum(x, dim=axis, dtype=torch.float32)
        zeros = torch.zeros_like(ii.narrow(axis, 0, 1))
        ii = torch.cat([zeros, ii], dim=axis)  # ii[i] = sum of the first i
        idx = torch.arange(n, device=x.device)
        hi = (idx + r + 1).clamp(max=n)
        lo = (idx - r).clamp(min=0)
        return ii.index_select(axis, hi) - ii.index_select(axis, lo)

    out = axis_boxsum(cost.to(torch.float32), 0)
    return axis_boxsum(out, 1)


def wta(agg: torch.Tensor, subpixel: bool = True, uniqueness: Optional[float] = None):
    """Winner-take-all over the last (disparity) axis: first minimum, optional
    parabolic subpixel for interior winners, optional uniqueness validity
    against the best cost outside ±1. Returns ``(disp, valid, cbest)``."""
    d = agg.shape[-1]
    best = torch.argmin(agg, dim=-1)  # first minimum
    cbest = agg.gather(-1, best[..., None])[..., 0]
    disp = best.to(torch.float32)
    if subpixel and d >= 3:
        bm = best.clamp(1, d - 2)
        cm1 = agg.gather(-1, (bm - 1)[..., None])[..., 0]
        c0 = agg.gather(-1, bm[..., None])[..., 0]
        cp1 = agg.gather(-1, (bm + 1)[..., None])[..., 0]
        denom = cm1 - 2.0 * c0 + cp1
        delta = torch.where(
            denom.abs() > 1e-6, (cm1 - cp1) / (2.0 * denom), torch.zeros_like(denom)
        )
        delta = delta.clamp(-0.5, 0.5)
        interior = (best >= 1) & (best <= d - 2)
        disp = torch.where(interior, bm.to(torch.float32) + delta, disp)
    valid = torch.ones(best.shape, dtype=torch.bool, device=agg.device)
    if uniqueness is not None:
        near = (torch.arange(d, device=agg.device) - best[..., None]).abs() <= 1
        second = torch.where(near, torch.full_like(agg, float("inf")), agg).amin(-1)
        valid = valid & (cbest * (1.0 + uniqueness) <= second)
    return disp, valid, cbest


def median3(disp: torch.Tensor) -> torch.Tensor:
    """3×3 median with edge replicate: the rank-5 element of the sorted
    9-neighbourhood."""
    h, w = disp.shape
    rows = torch.arange(-1, h + 1, device=disp.device).clamp(0, h - 1)
    cols = torch.arange(-1, w + 1, device=disp.device).clamp(0, w - 1)
    padded = disp[rows][:, cols]
    stack = torch.stack(
        [padded[dy : dy + h, dx : dx + w] for dy in range(3) for dx in range(3)],
        dim=-1,
    )
    return torch.sort(stack, dim=-1).values[..., 4]


def disparity_to_depth_u8(disp: torch.Tensor, num_disparities: int) -> torch.Tensor:
    """Scale disparity to the reference's u8 depth convention (larger =
    closer): linear from [0, D−1] to [0, 255]."""
    d = disp.clamp(0.0, float(num_disparities - 1))
    return torch.round(d * (255.0 / float(num_disparities - 1))).to(torch.uint8)

"""Temporal ops over depth and mask video [T, H, W] (twin of
``stepth_tpu/ops/temporal.py``). Time is a leading axis; the mask
constants come from ``core/frame.py``, as in the reference."""

from __future__ import annotations

import torch

from stepth_tpu_torch.match.dense import to_tensor
from stepth_tpu_torch.core.frame import MASK_TRUE

_TRUE = MASK_TRUE


def _pad_time(x: torch.Tensor, r: int) -> torch.Tensor:
    """``x`` with its first and last frames repeated ``r`` times."""
    return torch.cat([x[:1].expand(r, *x.shape[1:]), x, x[-1:].expand(r, *x.shape[1:])], 0)


def temporal_median_depth(depths, window: int = 3) -> torch.Tensor:
    """Sliding temporal median over u8/f32 depth video [T, H, W] (an odd
    window; the ends repeat the first and last frame). The median is the
    reference's midpoint of the two middle values in f32 (one value for an
    odd window), cast back to the input's dtype."""
    depths = to_tensor(depths)
    t, r = depths.shape[0], window // 2
    padded = _pad_time(depths, r)
    stack = torch.stack([padded[k : k + t] for k in range(window)], 0)
    s = torch.sort(stack.to(torch.float32), dim=0).values
    mid = (s[(window - 1) // 2] + s[window // 2]) * 0.5
    return mid.to(depths.dtype)


def ema_depth(depths, alpha: float = 0.5) -> torch.Tensor:
    """Exponential moving average along time (f32 out)."""
    x = to_tensor(depths).to(torch.float32)
    out = [x[0]]
    for frame in x[1:]:
        out.append(alpha * frame + (1.0 - alpha) * out[-1])
    return torch.stack(out, 0)


def mask_stabilize(masks, window: int = 3, min_votes: int = 2) -> torch.Tensor:
    """Temporal vote over u8 masks [T, H, W]: TRUE where at least
    ``min_votes`` of the ``window`` neighbouring frames are TRUE."""
    masks = to_tensor(masks)
    t, r = masks.shape[0], window // 2
    padded = _pad_time((masks == _TRUE).to(torch.int32), r)
    votes = sum(padded[k : k + t] for k in range(window))
    return (votes >= min_votes).to(torch.uint8) * _TRUE


def mask_and_video(a, b) -> torch.Tensor:
    """Frame-wise mask AND over [T, H, W] (truth is == 255)."""
    return ((to_tensor(a) == _TRUE) & (to_tensor(b) == _TRUE)).to(torch.uint8) * _TRUE


def mask_or_video(a, b) -> torch.Tensor:
    return ((to_tensor(a) == _TRUE) | (to_tensor(b) == _TRUE)).to(torch.uint8) * _TRUE


def motion_mask(depths, threshold: float = 4.0) -> torch.Tensor:
    """TRUE where depth changed by more than ``threshold`` since the previous
    frame; frame 0 is all FALSE. u8 [T, H, W]."""
    d = to_tensor(depths).to(torch.float32)
    moving = torch.cat([torch.zeros_like(d[:1], dtype=torch.bool),
                        torch.abs(d[1:] - d[:-1]) > threshold], 0)
    return moving.to(torch.uint8) * _TRUE

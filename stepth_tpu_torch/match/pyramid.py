"""Image-pyramid helpers (twin of ``stepth_tpu/match/pyramid.py:24-47``)."""

from __future__ import annotations

import torch


def downsample2(gray: torch.Tensor) -> torch.Tensor:
    """2×2 average pool, odd trailing row/col dropped. Same add order as the
    reference ((top + bottom), then (left + right), then × 0.25), so the two
    agree bit for bit."""
    h, w = gray.shape
    g = gray[: h // 2 * 2, : w // 2 * 2]
    v = g[0::2] + g[1::2]
    return (v[:, 0::2] + v[:, 1::2]) * 0.25


def upsample2_disparity(disp: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Nearest-neighbour 2× upsample to (h, w); values double because pixel
    coordinates double. Odd targets are edge-padded."""
    up = disp.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1) * 2.0
    up = up[:h, :w]
    ph, pw = h - up.shape[0], w - up.shape[1]
    if ph or pw:
        rows = torch.arange(h, device=up.device).clamp(max=up.shape[0] - 1)
        cols = torch.arange(w, device=up.device).clamp(max=up.shape[1] - 1)
        up = up[rows][:, cols]
    return up

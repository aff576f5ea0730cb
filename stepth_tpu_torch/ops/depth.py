"""Depth-plane utilities (twin of ``stepth_tpu/ops/depth.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from stepth_tpu_torch.match.dense import to_tensor
from stepth_tpu_torch.ops.mask import MASK_TRUE


def invert(depth) -> torch.Tensor:
    """depth ← 255 − depth (u8)."""
    return 255 - to_tensor(depth).to(torch.uint8)


def highlight_depth(image, depth) -> torch.Tensor:
    """rgb ·= depth/255·2, clamped, truncating f32 cast; alpha unchanged.
    The divisor is a tensor on the image's device: torch divides by a
    Python scalar through its reciprocal on CUDA."""
    image = to_tensor(image).to(torch.uint8)
    depth = to_tensor(depth)
    d255 = torch.full((), 255.0, dtype=torch.float32, device=depth.device)
    mult = depth.to(torch.float32) / d255 * 2.0
    rgb = image[..., :3].to(torch.float32) * mult[..., None]
    rgb = torch.clamp(rgb, 0.0, 255.0).to(torch.uint8)
    return torch.cat([rgb, image[..., 3:]], dim=-1)


def slice_mask(depth, lo: Optional[int], hi: Optional[int]) -> torch.Tensor:
    """Mask TRUE where lo ≤ depth ≤ hi (None bounds are 0 and 255)."""
    lo = 0 if lo is None else int(lo)
    hi = 255 if hi is None else int(hi)
    depth = to_tensor(depth).to(torch.uint8)
    return ((depth >= lo) & (depth <= hi)).to(torch.uint8) * int(MASK_TRUE)

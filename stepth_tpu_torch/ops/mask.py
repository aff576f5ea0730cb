"""Mask algebra and masked-image ops (twin of ``stepth_tpu/ops/mask.py``).

Masks are u8 planes. Truth is **exact equality with 255**, so a resized
(gray) mask pixel is "not true", as in the system the reference
reproduces. Elementwise torch ops on the device of the inputs.
"""

from __future__ import annotations

from typing import Tuple

import torch

from stepth_tpu_torch.core.frame import MASK_FALSE, MASK_TRUE
from stepth_tpu_torch.match.dense import to_tensor

_TRUE, _FALSE = MASK_TRUE, MASK_FALSE


def _u8(x) -> torch.Tensor:
    return to_tensor(x).to(torch.uint8)


def _select(cond: torch.Tensor) -> torch.Tensor:
    """MASK_TRUE where ``cond``, else MASK_FALSE (u8)."""
    return cond.to(torch.uint8) * _TRUE


def conform(mask, dims: Tuple[int, int], rebinarize: bool = False) -> torch.Tensor:
    """Lenient mask sizing: a Gaussian resample to exactly ``dims`` (H, W)
    when the size differs; ``rebinarize`` then thresholds at 128."""
    from stepth_tpu_torch.ops import resize as resize_ops

    mask = _u8(mask)
    if (int(mask.shape[0]), int(mask.shape[1])) != tuple(dims):
        mask = resize_ops.resample_exact(mask, dims[0], dims[1], "gaussian")
    if rebinarize:
        mask = _select(mask >= 128)
    return mask


def mask_and(a, b) -> torch.Tensor:
    """TRUE where both are TRUE (operands already conformed)."""
    return _select((_u8(a) == _TRUE) & (_u8(b) == _TRUE))


def mask_or(a, b) -> torch.Tensor:
    return _select((_u8(a) == _TRUE) | (_u8(b) == _TRUE))


def mask_not(a) -> torch.Tensor:
    """Bitwise 255-complement, not a boolean not: gray stays gray."""
    return _TRUE - _u8(a)


def reset(dims: Tuple[int, int], device) -> torch.Tensor:
    """All-true mask on ``device``."""
    return torch.full(tuple(dims), _TRUE, dtype=torch.uint8, device=device)


def apply(image, mask) -> torch.Tensor:
    """Zero the pixels (all channels) where mask == MASK_FALSE **exactly**;
    gray mask pixels leave the image untouched."""
    image = _u8(image)
    keep = (_u8(mask) != _FALSE)[..., None]
    return image * keep


def highlight(image, mask) -> torch.Tensor:
    """Where TRUE: r·2 (clamped), g/2, b/2 on RGBA; alpha unchanged."""
    image = _u8(image)
    t = _u8(mask) == _TRUE
    r = torch.clamp(image[..., 0].to(torch.int32) * 2, max=255).to(torch.uint8)
    hi = torch.stack([r, image[..., 1] // 2, image[..., 2] // 2, image[..., 3]], dim=-1)
    return torch.where(t[..., None], hi, image)


def image_replace(image, mask, other, start_yx: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Copy ``other`` into ``image`` where mask == TRUE, reading ``other`` at
    **absolute** coordinates, inside the region from ``start_yx`` that both
    images cover (reads past ``other`` are clamped out)."""
    image = _u8(image)
    other = _u8(other)
    h, w = int(image.shape[0]), int(image.shape[1])
    oh, ow = int(other.shape[0]), int(other.shape[1])
    sy, sx = int(start_yx[0]), int(start_yx[1])
    y0, y1 = sy, min(sy + oh, h, oh)
    x0, x1 = sx, min(sx + ow, w, ow)
    if y1 <= y0 or x1 <= x0:
        return image
    take = torch.zeros((h, w), dtype=torch.bool, device=image.device)
    take[y0:y1, x0:x1] = _u8(mask)[y0:y1, x0:x1] == _TRUE
    src = torch.zeros_like(image)
    ch, cw = min(h, oh), min(w, ow)
    src[:ch, :cw] = other[:ch, :cw]
    return torch.where(take[..., None], src, image)

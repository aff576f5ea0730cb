"""Whole-image adjustments with image-rs colorops semantics (twin of
``stepth_tpu/ops/adjust.py``); the masked adjustments run one of these and
then ``mask.image_replace`` under the mask."""

from __future__ import annotations

import torch

from stepth_tpu_torch.match.dense import to_tensor
from stepth_tpu_torch.ops import resize as resize_ops


def _u8(image) -> torch.Tensor:
    return to_tensor(image).to(torch.uint8)


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    """A scalar as an f32 tensor on ``like``'s device (a tensor operand, not
    a Python scalar, which torch divides by through its reciprocal on
    CUDA)."""
    return torch.full((), x, dtype=torch.float32, device=like.device)


def brighten(image, value: int) -> torch.Tensor:
    """Saturating add on the colour channels; alpha unchanged."""
    image = _u8(image)
    rgb = torch.clamp(image[..., :3].to(torch.int32) + int(value), 0, 255).to(torch.uint8)
    return torch.cat([rgb, image[..., 3:]], dim=-1)


def contrast(image, c: float) -> torch.Tensor:
    """image-rs ``adjust_contrast``: percent = ((100 + c)/100)²,
    d = clamp(((v/255 − 0.5)·percent + 0.5)·255), truncating cast; alpha
    unchanged. f32 throughout, as the reference."""
    image = _u8(image)
    percent = ((100.0 + _f32(c, image)) / _f32(100.0, image)) ** 2
    v = image[..., :3].to(torch.float32) / _f32(255.0, image)
    d = ((v - 0.5) * percent + 0.5) * 255.0
    rgb = torch.clamp(d, 0.0, 255.0).to(torch.uint8)
    return torch.cat([rgb, image[..., 3:]], dim=-1)


def blur(image, sigma: float) -> torch.Tensor:
    """image-rs ``blur``: a same-size gaussian(sigma) resample over all
    channels."""
    return resize_ops.blur_u8(_u8(image), float(sigma))


def unsharpen(image, sigma: float, threshold: int) -> torch.Tensor:
    """image-rs ``unsharpen``: orig + (orig − blur(sigma)) where |orig −
    blurred| > threshold, clamped; all channels."""
    image = _u8(image)
    a = image.to(torch.int32)
    diff = a - blur(image, sigma).to(torch.int32)
    sharp = torch.clamp(a + diff, 0, 255)
    return torch.where(torch.abs(diff) > threshold, sharp, a).to(torch.uint8)

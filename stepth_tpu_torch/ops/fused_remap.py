"""Kernel K11, the bilinear remap behind rectification, with its plain version
(twin of ``stepth_tpu/ops/pallas_remap.py``).

The TPU kernel needs a host plan per rig (``plan_remap``: per-tile source
offsets, so that it can roll a band instead of gathering) and rejects maps
that are not smooth. A GPU gathers, so K11 samples the map directly: there
is no plan, and any map works. :func:`remap_bilinear_fused` launches K11 for
CUDA tensors and runs the plain version, ``rectify.remap_bilinear``, for
CPU tensors. Kernel and plain version round every product and sum in the
same order, so they agree bit for bit (``csrc/fused_remap.cu``).
"""

from __future__ import annotations

import torch

from stepth_tpu_torch import kernels
from stepth_tpu_torch.ops import rectify

K11 = kernels.Kernel(
    "K11",
    "K11 remap_bilinear",
    "stepth_remap_bilinear",
    [kernels.PTR] * 3 + [kernels.INT] * 5 + [kernels.FLOAT],
    source="stepth_tpu_torch/csrc/fused_remap.cu",
    replaces="stepth_tpu/ops/pallas_remap.py:187",
)


def remap_bilinear_plain(img: torch.Tensor, map_xy: torch.Tensor,
                         fill: float = 0.0) -> torch.Tensor:
    """K11's plain version: ``rectify.remap_bilinear``."""
    return rectify.remap_bilinear(img, map_xy, fill)


def remap_bilinear_fused(img: torch.Tensor, map_xy: torch.Tensor,
                         fill: float = 0.0) -> torch.Tensor:
    """Bilinear warp of f32 ``img`` [Hs, Ws] or [Hs, Ws, C] through
    ``map_xy`` f32[H, W, 2] ((x, y) source coordinates), ``fill`` outside
    the source: K11 on CUDA tensors (one launch whatever C; any contiguous
    view, aligned or not), the plain version on CPU tensors."""
    if img.device.type == "cpu":
        return remap_bilinear_plain(img, map_xy, fill)
    if img.ndim not in (2, 3):
        raise ValueError(f"remap: image must be [H, W] or [H, W, C], got {tuple(img.shape)}")
    kernels.check_cuda_tensor("remap image", img, torch.float32, img.ndim)
    kernels.check_cuda_tensor("remap map", map_xy, torch.float32, 3)
    if map_xy.shape[-1] != 2 or map_xy.device != img.device:
        raise ValueError(f"remap: map must be [H, W, 2] on {img.device}, got "
                         f"{tuple(map_xy.shape)} on {map_xy.device}")
    hs, ws = img.shape[:2]
    c = img.shape[2] if img.ndim == 3 else 1
    h, w = map_xy.shape[:2]
    out = torch.empty((h, w) + tuple(img.shape[2:]), dtype=torch.float32, device=img.device)
    if out.numel() == 0:  # an empty grid is not a valid launch
        return out
    K11.launch(img.device, img.data_ptr(), map_xy.data_ptr(), out.data_ptr(),
               hs, ws, h, w, c, float(fill))
    return out

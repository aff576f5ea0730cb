"""Post-processing kernels K3 (3×3 median), K4 (LR consistency check) and
K5 (scanline occlusion fill), each with its plain version (twin of
``stepth_tpu/match/pallas_post.py``).

Each ``*_fused`` wrapper launches its CUDA kernel for CUDA tensors and runs
the ``*_plain`` version for CPU tensors. All three are selections or
comparisons, not arithmetic that could be reordered, so each kernel
equals its plain version on the same device bit for bit: the median
applies the reference's 19-comparator network with edge replicate, the LR
check and the fill are ``dense.lr_consistency`` and ``dense.fill_invalid``.

NaN follows ``torch.minimum``/``torch.maximum``: a NaN operand wins every
exchange of the median and the fill's minimum (where the kernel's NaN may
carry other bits, so NaN is compared by position). The sign of a zero is
the device's: the kernels use the instructions torch's CUDA ``minimum``/
``maximum`` use, and the reference's ``jnp.minimum`` (−0 below +0) may give
the other sign where torch does not order the zeros. Values are the
reference's everywhere; the median equals ``dense.median3`` where no NaN is
present (a sort puts NaN last).
"""

from __future__ import annotations

import torch

from stepth_tpu_torch import kernels
from stepth_tpu_torch.match import dense

K3 = kernels.Kernel(
    "K3",
    "K3 median3",
    "stepth_median3",
    [kernels.PTR, kernels.PTR, kernels.INT, kernels.INT],
    source="stepth_tpu_torch/csrc/fused_post.cu",
    replaces="stepth_tpu/match/pallas_post.py:47",
)
K4 = kernels.Kernel(
    "K4",
    "K4 lr_check",
    "stepth_lr_check",
    [kernels.PTR] * 3 + [kernels.INT] * 3 + [kernels.FLOAT],
    source="stepth_tpu_torch/csrc/fused_post.cu",
    replaces="stepth_tpu/match/pallas_post.py:84",
)
K5 = kernels.Kernel(
    "K5",
    "K5 fill_invalid",
    "stepth_fill_invalid",
    [kernels.PTR] * 3 + [kernels.INT] * 2,
    source="stepth_tpu_torch/csrc/fused_post.cu",
    replaces="stepth_tpu/match/pallas_post.py:137",
)

# the 19-comparator median-of-9 sorting network (Smith); pairs (lo, hi)
_MEDIAN9_NET = [
    (1, 2), (4, 5), (7, 8),
    (0, 1), (3, 4), (6, 7),
    (1, 2), (4, 5), (7, 8),
    (0, 3), (5, 8), (4, 7),
    (3, 6), (1, 4), (2, 5),
    (4, 7), (4, 2), (6, 4),
    (4, 2),
]


def median3_plain(x: torch.Tensor) -> torch.Tensor:
    """K3's plain version: the median network over the nine edge-replicated
    shifts of ``x`` f32[H, W]."""
    h, w = x.shape
    rows = torch.arange(-1, h + 1, device=x.device).clamp(0, h - 1)
    cols = torch.arange(-1, w + 1, device=x.device).clamp(0, w - 1)
    padded = x[rows][:, cols]
    p = [padded[dy : dy + h, dx : dx + w] for dy in range(3) for dx in range(3)]
    for a, b in _MEDIAN9_NET:
        p[a], p[b] = torch.minimum(p[a], p[b]), torch.maximum(p[a], p[b])
    return p[4]


def median3_fused(x: torch.Tensor) -> torch.Tensor:
    """3×3 median of f32[H, W]: K3 on a CUDA tensor, the plain version on a
    CPU tensor."""
    if x.device.type == "cpu":
        return median3_plain(x)
    kernels.check_cuda_tensor("median3 input", x, torch.float32, 2)
    h, w = x.shape
    out = torch.empty_like(x)
    K3.launch(x.device, x.data_ptr(), out.data_ptr(), h, w)
    return out


def lr_consistency_plain(disp_l: torch.Tensor, disp_r: torch.Tensor,
                         threshold: float = 1.0, num_disparities: int = 128) -> torch.Tensor:
    """K4's plain version: ``dense.lr_consistency`` (bool[H, W])."""
    return dense.lr_consistency(disp_l, disp_r, threshold, num_disparities)


def lr_consistency_fused(disp_l: torch.Tensor, disp_r: torch.Tensor,
                         threshold: float = 1.0, num_disparities: int = 128) -> torch.Tensor:
    """LR validity bool[H, W] of f32 disparity maps (twin of
    ``lr_consistency_pallas``): K4 on CUDA tensors, the plain version on CPU
    tensors. A right-view value of −1e6 (no candidate) is never valid."""
    if disp_l.device.type == "cpu":
        return lr_consistency_plain(disp_l, disp_r, threshold, num_disparities)
    kernels.check_cuda_tensor("lr_check left", disp_l, torch.float32, 2)
    kernels.check_cuda_tensor("lr_check right", disp_r, torch.float32, 2)
    if disp_r.shape != disp_l.shape or disp_r.device != disp_l.device:
        raise ValueError(f"lr_check: {tuple(disp_l.shape)} vs {tuple(disp_r.shape)}")
    h, w = disp_l.shape
    out = torch.empty((h, w), dtype=torch.bool, device=disp_l.device)
    K4.launch(disp_l.device, disp_l.data_ptr(), disp_r.data_ptr(), out.data_ptr(),
              h, w, int(num_disparities), float(threshold))
    return out


def fill_invalid_plain(disp: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """K5's plain version: ``dense.fill_invalid`` (nearest valid index to the
    left by ``cummax``, to the right by a reversed ``cummin``)."""
    return dense.fill_invalid(disp, valid)


def fill_invalid_fused(disp: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Scanline occlusion fill of f32[H, W] under bool[H, W] validity (twin
    of ``fill_invalid_pallas``): K5 on CUDA tensors, the plain version on
    CPU tensors."""
    if disp.device.type == "cpu":
        return fill_invalid_plain(disp, valid)
    kernels.check_cuda_tensor("fill disp", disp, torch.float32, 2)
    kernels.check_cuda_tensor("fill valid", valid, torch.bool, 2)
    if valid.shape != disp.shape or valid.device != disp.device:
        raise ValueError(f"fill: {tuple(disp.shape)} vs {tuple(valid.shape)}")
    h, w = disp.shape
    out = torch.empty_like(disp)
    K5.launch(disp.device, disp.data_ptr(), valid.data_ptr(), out.data_ptr(), h, w)
    return out

"""3×3 median post-filter: kernel K3 and its plain version (twin of
``stepth_tpu/match/pallas_post.py:26-81, 270-299``).

:func:`median3_fused` launches the CUDA kernel for a CUDA tensor and runs
:func:`median3_plain` for a CPU tensor. Both apply the reference's
19-comparator median-of-9 network with edge replicate, so they equal
``dense.median3`` bit for bit.
"""

from __future__ import annotations

import torch

from stepth_tpu_torch import kernels

K3 = kernels.Kernel(
    "K3 median3",
    "stepth_median3",
    [kernels.PTR, kernels.PTR, kernels.INT, kernels.INT],
    source="stepth_tpu_torch/csrc/fused_post.cu",
    replaces="stepth_tpu/match/pallas_post.py:47",
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

"""Dense rectified-stereo matcher in plain PyTorch (twin of
``stepth_tpu/match/dense.py``).

These are the reference semantics the fused kernels are held to: grayscale,
the census transform, the [H, W, D] cost volume (SAD, SSD or census Hamming)
with an edge-replicated shifted right image, the zero-padded box aggregation,
winner-take-all with parabolic subpixel and uniqueness, the right-view WTA,
the LR consistency check, the scanline occlusion fill, the 3×3 median and
the u8 depth scaling; :func:`match_pair` chains them (the ``dense``
backend).

Census descriptors are stored as **int32 bit patterns** (the reference uses
uint32): torch has no shift for uint32 on every device, and a Hamming
distance only needs the bits. :func:`census_pair`, the census of the
kernels' pipelines, launches the census kernel (``csrc/fused_census.cu``)
for CUDA tensors; :func:`census_pair_plain` is its plain version, and the
kernels' plain versions take their census from it on any device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from stepth_tpu_torch import kernels
from stepth_tpu_torch.config import MatchConfig
from stepth_tpu_torch.utils import tracing

_CENSUS_MAX_RADIUS = 7  # census windows up to 15 (7 planes), the widest K2 and K6 take
CENSUS = kernels.Kernel(
    "census",
    "census",
    "stepth_census_pair",
    [kernels.PTR] * 3 + [kernels.INT] * 3,
    source="stepth_tpu_torch/csrc/fused_census.cu",
    replaces="none (the XLA glue of stepth_tpu/match/dense.py:57 census_transform)",
)


class MatchResult(NamedTuple):
    """Disparity output of the dense matcher."""

    disparity: torch.Tensor  # f32[H, W]; -1 where invalid
    valid: torch.Tensor  # bool[H, W]
    cost: torch.Tensor  # f32[H, W] winning aggregated cost (diagnostics)


def default_device(device=None) -> torch.device:
    """``device``, or the card (``"cuda"``) when it is None. Entry points run
    on the card unless the caller names another device: with no CUDA device
    this raises instead of running on the CPU (``device="cpu"`` asks for
    it)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise ValueError("array input runs on device='cuda' by default, and no CUDA device "
                         "is available; pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def to_tensor(x, device=None) -> torch.Tensor:
    """``x`` as a tensor. A tensor keeps its device (``device``, if given,
    must agree); an array goes to ``device``, by default the card
    (:func:`default_device`)."""
    if isinstance(x, torch.Tensor):
        if device is not None and x.device != torch.device(device):
            raise ValueError(f"tensor on {x.device}, but device={device!r}")
        return x
    return torch.as_tensor(np.asarray(x), device=default_device(device))


def grayscale(rgb, device=None) -> torch.Tensor:
    """Rec.709 luma in f32, contiguous (a 2-D input is taken as gray
    already)."""
    rgb = to_tensor(rgb, device)
    if rgb.ndim == 2:
        return rgb.to(torch.float32).contiguous()
    rgb = rgb[..., :3].to(torch.float32)
    return 0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]


def census_planes(gray: torch.Tensor, window: int = 7) -> torch.Tensor:
    """Census descriptors of gray [..., H, W] as int32 planes [P, ..., H, W],
    contiguous (the layout the kernels read; a leading batch dim costs both
    views of a pair in one pass). Bit ``i`` of plane ``p`` is neighbour
    ``32·p + i`` in ``(dy, dx)`` row-major order with the centre skipped,
    set where ``gray > neighbour``; neighbours outside the image are
    edge-replicated. Bits are gathered eight neighbours per op as a sum of
    distinct powers of two (their OR), in int32 where bit 31 weighs −2³¹:
    the bits are the reference's uint32 bits."""
    h, w = gray.shape[-2:]
    r = window // 2
    dev = gray.device
    rows = torch.arange(-r, h + r, device=dev).clamp(0, h - 1)
    cols = torch.arange(-r, w + r, device=dev).clamp(0, w - 1)
    padded = gray[..., rows, :][..., cols]
    offs = [(dy, dx) for dy in range(-r, r + 1) for dx in range(-r, r + 1) if dy or dx]
    # 1 << i as int32 bit patterns: bit 31 is int32's minimum (no shift into
    # the sign bit)
    i = torch.arange(32, dtype=torch.int32, device=dev)
    weight = torch.where(i < 31, torch.ones_like(i) << i.clamp(max=30),
                         torch.iinfo(torch.int32).min)
    wshape = (-1,) + (1,) * gray.ndim
    planes = []
    for p in range(0, len(offs), 32):
        acc = torch.zeros(gray.shape, dtype=torch.int32, device=dev)
        for g in range(p, min(p + 32, len(offs)), 8):
            group = offs[g : min(g + 8, p + 32, len(offs))]
            nbs = torch.stack([padded[..., dy + r : dy + r + h, dx + r : dx + r + w]
                               for dy, dx in group])
            wts = weight[g - p : g - p + len(group)].reshape(wshape)
            acc = acc + ((gray[None] > nbs) * wts).sum(0, dtype=torch.int32)
        planes.append(acc)
    return torch.stack(planes).contiguous()


def census_plane_count(window: int) -> int:
    """P, the int32 planes that hold a census window's (2·(window // 2) +
    1)² − 1 neighbour bits."""
    k = 2 * (window // 2) + 1
    return (k * k - 1 + 31) // 32


@tracing.annotate("stepth/census")
def census_pair_plain(left: torch.Tensor, right: torch.Tensor, window: int = 7):
    """Census planes [P, H, W] of both views of a pair, in one pass of
    :func:`census_planes`, on any device: the census kernel's plain version,
    and the census of the kernels' plain versions."""
    planes = census_planes(torch.stack([left, right]), window)
    return planes[:, 0].contiguous(), planes[:, 1].contiguous()


@tracing.annotate("stepth/census")
def census_pair(left: torch.Tensor, right: torch.Tensor, window: int = 7):
    """Census planes [P, H, W] of both views of a pair: one launch of the
    census kernel for CUDA tensors (census windows 2–15; f32, 2-D, one
    shape, contiguous, else it raises), :func:`census_pair_plain` for CPU
    tensors. Bit for bit the same planes; counts ``census.kernel`` or
    ``census.plain`` once a pair, by the branch taken."""
    if left.device.type == "cpu":
        tracing.count("census.plain")
        # the plain census without its own span: this call's is open
        return census_pair_plain.__wrapped__(left, right, window)
    kernels.check_cuda_tensor("census left", left, torch.float32, 2)
    kernels.check_cuda_tensor("census right", right, torch.float32, 2)
    if right.shape != left.shape or right.device != left.device:
        raise ValueError(f"census: left {tuple(left.shape)} on {left.device} / right "
                         f"{tuple(right.shape)} on {right.device} differ")
    r = window // 2
    if not 1 <= r <= _CENSUS_MAX_RADIUS:
        raise ValueError(f"census: the kernel takes census windows 2-15, got {window}")
    h, w = left.shape
    planes = torch.empty((2, census_plane_count(window), h, w), dtype=torch.int32,
                         device=left.device)
    CENSUS.launch(left.device, left.data_ptr(), right.data_ptr(), planes.data_ptr(), h, w, r)
    tracing.count("census.kernel")
    return planes[0], planes[1]


def census_transform(gray: torch.Tensor, window: int = 7) -> torch.Tensor:
    """Census bit strings per pixel, int32 [H, W, P] (the reference's
    uint32 [H, W, P] bit for bit)."""
    return census_planes(gray, window).permute(1, 2, 0)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 ``x`` as int64. A SWAR count on the value
    widened to int64 and masked to 32 bits, so no shift ever sees a negative
    number."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def _shift_right_image(img: torch.Tensor, num_disparities: int) -> torch.Tensor:
    """[H, W, D, ...]: out[:, x, d] is the right image sampled at ``x − d``,
    edge-replicated where ``x − d < 0``."""
    w = img.shape[1]
    x = torch.arange(w, device=img.device)[:, None]
    d = torch.arange(num_disparities, device=img.device)[None, :]
    return img[:, (x - d).clamp(min=0)]


def cost_volume(left_gray, right_gray, cfg: MatchConfig) -> torch.Tensor:
    """Per-pixel matching cost f32[H, W, D] (smaller = better): SAD, SSD or
    the census Hamming distance summed over the planes."""
    if cfg.cost == "census":
        cl = census_transform(left_gray, cfg.census_window)  # [H, W, P]
        crs = _shift_right_image(census_transform(right_gray, cfg.census_window),
                                 cfg.num_disparities)  # [H, W, D, P]
        return popcount32(cl[:, :, None, :] ^ crs).sum(-1).to(torch.float32)
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


def right_disparity_from_volume(agg: torch.Tensor) -> torch.Tensor:
    """Right-view disparity f32[H, W] from the left volume:
    costR(y, x, d) = costL(y, x + d, d), first minimum over ascending d
    (``inf`` past the right edge)."""
    h, w, d = agg.shape
    best = torch.full((h, w), float("inf"), dtype=agg.dtype, device=agg.device)
    bestd = torch.zeros((h, w), dtype=torch.float32, device=agg.device)
    for k in range(d):
        kk = min(k, w)
        shifted = torch.cat(
            [agg[:, kk:, k], torch.full((h, kk), float("inf"), dtype=agg.dtype,
                                        device=agg.device)], dim=1
        )
        upd = shifted < best
        best = torch.where(upd, shifted, best)
        bestd = torch.where(upd, float(k), bestd)
    return bestd


def lr_consistency(disp_l: torch.Tensor, disp_r: torch.Tensor, threshold: float,
                   num_disparities: Optional[int] = None) -> torch.Tensor:
    """Validity bool[H, W]: ``|dL(x) − dR(xr)| ≤ threshold`` with
    ``xr = clip(round(x − dL), 0, W−1)``, as the reference's sweep over
    shifts ``s < D`` selects it: for ``xr ≥ 1`` the shift ``x − xr`` must lie
    in ``[0, D)``; for ``xr = 0`` every ``s ≥ x`` samples the edge column, so
    ``x < D`` suffices. A closed form of the same selection (bit-equal)."""
    h, w = disp_l.shape
    D = w if num_disparities is None else num_disparities
    x = torch.arange(w, dtype=torch.float32, device=disp_l.device)[None, :]
    xr = torch.round(x - disp_l).clamp(0.0, float(w - 1))
    shift = x - xr
    in_range = torch.where(xr >= 1.0, (shift >= 0) & (shift < D), x < D)
    dr_at = disp_r.gather(1, xr.to(torch.int64).clamp(0, w - 1))
    return in_range & ((disp_l - dr_at).abs() <= threshold)


def fill_invalid(disp: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Scanline occlusion fill: each invalid pixel takes the smaller of the
    nearest valid disparities to its left and right (0 where there is
    neither); valid pixels keep theirs. Selects only."""
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


def match_pair(left, right, cfg: MatchConfig = MatchConfig(), device=None) -> MatchResult:
    """The full dense matcher on a rectified pair (the ``dense`` backend):
    cost volume, box aggregation, WTA, the optional LR check against the
    right-view disparity of the same volume, occlusion fill and median."""
    lg = grayscale(left, device)
    rg = grayscale(right, device)
    agg = box_aggregate(cost_volume(lg, rg, cfg), cfg.window)
    disp, valid, cbest = wta(agg, cfg.subpixel, cfg.uniqueness)
    if cfg.lr_threshold is not None:
        disp_r = right_disparity_from_volume(agg)
        valid = valid & lr_consistency(disp, disp_r, cfg.lr_threshold, cfg.num_disparities)
    disp = median3(fill_invalid(disp, valid))
    return MatchResult(disparity=disp, valid=valid, cost=cbest)

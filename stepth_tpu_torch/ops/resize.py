"""Separable image resampling with image-rs 0.23 ``imageops::resize`` taps
(twin of ``stepth_tpu/ops/resize.py``).

The tap indices and weights are computed on the host in f64 and quantized
to Q15 fixed point (the reference's normative choice: integer sums give the
same bits on every backend); the two int32 passes run on the image's
device. So the port equals the reference bit for bit.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Callable, Tuple

import numpy as np
import torch

from stepth_tpu_torch.match.dense import to_tensor

_Q = 15  # fixed-point fraction bits; the weights of one output sum to 1 << _Q
_MAX_TAPS = 1 << 8  # int32 accumulator headroom: 255 * 2^15 * 256 < 2^31


def gaussian_kernel(sigma: float) -> Callable[[float], float]:
    def k(x: float) -> float:
        return math.exp(-(x * x) / (2.0 * sigma * sigma)) / (math.sqrt(2 * math.pi) * sigma)

    return k


def triangle_kernel(x: float) -> float:
    return max(0.0, 1.0 - abs(x))


def catmullrom_kernel(x: float) -> float:
    a = abs(x)
    if a < 1.0:
        return (9.0 * a**3 - 15.0 * a**2 + 6.0) / 6.0
    if a < 2.0:
        return (-3.0 * a**3 + 15.0 * a**2 - 24.0 * a + 12.0) / 6.0
    return 0.0


def lanczos3_kernel(x: float) -> float:
    if x == 0.0:
        return 1.0
    a = abs(x)
    if a >= 3.0:
        return 0.0
    px = math.pi * x
    return 3.0 * math.sin(px) * math.sin(px / 3.0) / (px * px)


FILTERS: dict[str, Tuple[Callable[[float], float], float]] = {
    # name -> (kernel, support); Gaussian is image-rs FilterType::Gaussian
    # (sigma 1.0, support 3.0)
    "gaussian": (gaussian_kernel(1.0), 3.0),
    "triangle": (triangle_kernel, 1.0),
    "catmullrom": (catmullrom_kernel, 2.0),
    "lanczos3": (lanczos3_kernel, 3.0),
}


@lru_cache(maxsize=256)
def _pass_weights(n_in: int, n_out: int, filter_name: str,
                  sigma: float | None) -> Tuple[np.ndarray, np.ndarray]:
    """Per-output tap indices and Q15 weights of one pass, (idx i32[n_out,
    T], w i32[n_out, T]); padding taps have weight 0 and index 0."""
    if sigma is not None:
        # blur: gaussian(sigma), support 2·sigma, same size
        kernel, support = gaussian_kernel(max(sigma, 1e-6)), 2.0 * max(sigma, 0.0)
        support = max(support, 1e-3)
    else:
        kernel, support = FILTERS[filter_name]
    ratio = n_in / n_out
    sratio = max(ratio, 1.0)
    src_support = support * sratio

    lefts = np.empty(n_out, dtype=np.int64)
    rights = np.empty(n_out, dtype=np.int64)
    centers = np.empty(n_out, dtype=np.float64)
    for o in range(n_out):
        c = (o + 0.5) * ratio
        left = int(np.clip(math.floor(c - src_support), 0, n_in - 1))
        right = int(np.clip(math.ceil(c + src_support), left + 1, n_in))
        lefts[o], rights[o], centers[o] = left, right, c - 0.5
    taps = int((rights - lefts).max())
    if taps > _MAX_TAPS:
        raise ValueError(f"resample {n_in}->{n_out}: {taps} taps exceeds {_MAX_TAPS}; "
                         "pre-halve extreme downscales")
    idx = np.zeros((n_out, taps), dtype=np.int32)
    wq = np.zeros((n_out, taps), dtype=np.int32)
    one = 1 << _Q
    for o in range(n_out):
        l, r, c = int(lefts[o]), int(rights[o]), centers[o]
        xs = np.arange(l, r, dtype=np.float64)
        ws = np.array([kernel((i - c) / sratio) for i in xs], dtype=np.float64)
        s = ws.sum()
        ws = np.ones_like(ws) / len(ws) if s == 0.0 else ws / s
        q = np.round(ws * one).astype(np.int64)
        # the rounding residue goes to the largest-|w| tap, so sums are exact
        q[np.argmax(np.abs(q))] += one - q.sum()
        idx[o, : r - l] = xs.astype(np.int32)
        wq[o, : r - l] = q.astype(np.int32)
    return idx, wq


def _resample_axis0(img: torch.Tensor, idx: np.ndarray, wq: np.ndarray) -> torch.Tensor:
    """One pass along axis 0, int32[n_in, ...] → int32[n_out, ...]:
    floor(Σ_t w·x / 2^Q) clamped to [0, 255]."""
    dev = img.device
    idx_t = torch.as_tensor(idx, device=dev).long()
    wq_t = torch.as_tensor(wq, device=dev)
    shape = (-1,) + (1,) * (img.ndim - 1)
    acc = torch.zeros((idx.shape[0],) + tuple(img.shape[1:]), dtype=torch.int32, device=dev)
    for t in range(idx.shape[1]):
        acc = acc + wq_t[:, t].reshape(shape) * img.index_select(0, idx_t[:, t])
    return torch.clamp(acc >> _Q, 0, 255)


def resample_exact(img, out_h: int, out_w: int, filter_name: str = "gaussian",
                   sigma: float | None = None) -> torch.Tensor:
    """image-rs ``resize_exact``: the vertical pass, then the horizontal one.
    ``img`` u8[H, W] or u8[H, W, C]; the same rank at (out_h, out_w).
    ``sigma`` switches to the blur kernel (gaussian(sigma), support 2σ)."""
    img = to_tensor(img)
    h, w = int(img.shape[0]), int(img.shape[1])
    vidx, vw = _pass_weights(h, out_h, filter_name, sigma)
    hidx, hw_ = _pass_weights(w, out_w, filter_name, sigma)
    x = _resample_axis0(img.to(torch.int32), vidx, vw)
    x = _resample_axis0(x.transpose(0, 1), hidx, hw_).transpose(0, 1)
    return x.to(torch.uint8).contiguous()


def resize_dimensions(width: int, height: int, nwidth: int, nheight: int,
                      fill: bool = False) -> Tuple[int, int]:
    """Aspect-preserving target size (image-rs ``resize_dimensions``);
    returns (width, height)."""
    ratio = width * nheight
    nratio = nwidth * height
    use_width = (nratio > ratio) if fill else (nratio <= ratio)
    if use_width:
        return nwidth, max(1, (height * nwidth) // width)
    return max(1, (width * nheight) // height), nheight


def resize_u8(img, height: int, width: int, filter_name: str = "gaussian") -> torch.Tensor:
    """image-rs ``DynamicImage::resize`` (aspect-preserving) on a u8 image."""
    img = to_tensor(img)
    tw, th = resize_dimensions(int(img.shape[1]), int(img.shape[0]), width, height)
    return resample_exact(img, th, tw, filter_name)


def blur_u8(img, sigma: float) -> torch.Tensor:
    """image-rs ``blur``: a same-size gaussian(sigma) resample, support 2σ
    (sigma ≤ 0 is taken as 1.0)."""
    img = to_tensor(img)
    sigma = 1.0 if sigma <= 0.0 else float(sigma)
    return resample_exact(img, int(img.shape[0]), int(img.shape[1]), sigma=sigma)

"""Stereo-pair brightness normalization (twin of ``stepth_tpu/ops/photometric.py``).

Two variants:

* ``*_exact``: NumPy host functions with the f64/u64 arithmetic of the
  system the reference reproduces, copied unchanged;
* :func:`normalize_brightness_f32`: the device version in torch (f32 gains,
  f32 means), which may differ from the exact one by 1 LSB.
"""

from __future__ import annotations

import numpy as np
import torch

from stepth_tpu_torch.match.dense import to_tensor


def _rust_cast_u16(x: np.ndarray) -> np.ndarray:
    """Rust ``as u16`` from f64: truncate toward zero, saturate out-of-range,
    NaN → 0."""
    out = np.clip(np.trunc(x), 0.0, 65535.0)
    return np.where(np.isnan(x), 0.0, out).astype(np.uint16)


def normalize_brightness_luma16_exact(img1, img2, percent: float) -> np.ndarray:
    """Integer floor means, f64 gain, Rust cast to u16; a no-op when |1 −
    gain| < percent. An all-zero img1 gives gain = inf (zero pixels → 0,
    others saturate)."""
    a = np.asarray(img1, dtype=np.uint16)
    b = np.asarray(img2, dtype=np.uint16)
    fbr = np.float64(int(a.sum(dtype=np.uint64)) // a.size)
    sbr = np.float64(int(b.sum(dtype=np.uint64)) // b.size)
    with np.errstate(divide="ignore", invalid="ignore"):
        diff = sbr / fbr
    if abs(1.0 - diff) < percent:
        return a.copy()
    return _rust_cast_u16(a.astype(np.float64) * diff)


def normalize_brightness_rgb16_exact(img1, img2, percent: float) -> np.ndarray:
    """Per-channel f64 means and gains; a no-op only when all three gains are
    within tolerance."""
    a = np.asarray(img1, dtype=np.uint16)
    b = np.asarray(img2, dtype=np.uint16)
    m1 = a.reshape(-1, 3).astype(np.float64).sum(axis=0) / (a.size // 3)
    m2 = b.reshape(-1, 3).astype(np.float64).sum(axis=0) / (b.size // 3)
    with np.errstate(divide="ignore", invalid="ignore"):
        diff = m2 / m1
    if np.all(np.abs(1.0 - diff) < percent):
        return a.copy()
    return _rust_cast_u16(a.astype(np.float64) * diff)


def normalize_brightness_f32(img1, img2, percent: float = 0.0, device=None) -> torch.Tensor:
    """Gain match on the device: scale img1's channels so that their means
    equal img2's. Integer images (u8, u16), [..., C] with C channels when
    they have 3 or more dims, else one channel; returns img1's dtype. The
    means are f32 ``torch.mean``s (another summation order than the
    reference's, so a pixel may land 1 LSB apart)."""
    a = to_tensor(img1, device)
    b = to_tensor(img2, device)
    info = torch.iinfo(a.dtype)
    lo, hi = info.min, info.max
    dims = tuple(range(a.ndim - 1)) if a.ndim >= 3 else tuple(range(a.ndim))
    af = a.to(torch.float32)
    m1 = af.mean(dim=dims)
    m2 = b.to(torch.float32).mean(dim=dims)
    gain = m2 / torch.clamp(m1, min=1e-6)
    apply = torch.any(torch.abs(1.0 - gain) >= percent)
    scaled = torch.clamp(af * gain, lo, hi).trunc()
    return torch.where(apply, scaled, af).to(a.dtype)

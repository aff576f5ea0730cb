"""Rendered stereo scenes with depth edges, for the traffic generator.

Rectified geometry, ``left(y, x) == right(y, x − d)``: each layer owns a
disparity field on left coordinates and a texture attached to the left
frame, 4× oversampled in x and sampled bilinearly; the right view warps each
layer by inverting ``x − D(y, x) = u`` (fixed point), compositing back to
front, so the band behind an object's edge shows texture the other view
does not have.

``box``: two textured rectangles at 0.70 and 0.50 of ``dmax`` over a
slanted textured background.
"""

from __future__ import annotations

import zlib

import numpy as np

_OS = 4  # texture oversampling along x


def _smooth_noise(rng, h: int, w: int, sigma: float = 2.0, lo: float = 16.0,
                  hi: float = 240.0) -> np.ndarray:
    """Uniform noise blurred ``round(sigma)`` times by a [1, 2, 1]/4 kernel
    along each axis (edge-replicated), stretched to [lo, hi]."""
    t = rng.uniform(0.0, 1.0, (h, w)).astype(np.float32)
    for _ in range(max(1, int(round(sigma)))):
        up = np.concatenate([t[:1], t[:-1]])
        down = np.concatenate([t[1:], t[-1:]])
        t = (up + 2.0 * t + down) * 0.25
        left = np.concatenate([t[:, :1], t[:, :-1]], axis=1)
        right = np.concatenate([t[:, 1:], t[:, -1:]], axis=1)
        t = (left + 2.0 * t + right) * 0.25
    t = t - t.min()
    if t.max() > 0:
        t = t / t.max()
    return (lo + t * (hi - lo)).astype(np.float32)


def _sample_x(tex: np.ndarray, xs: np.ndarray) -> np.ndarray:
    """Bilinear sample of ``tex`` along x at texture coordinates ``xs``."""
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, tex.shape[1] - 2)
    f = np.clip(xs.astype(np.float64) - x0, 0.0, 1.0).astype(np.float32)
    rows = np.arange(tex.shape[0])[:, None]
    return tex[rows, x0] * (1.0 - f) + tex[rows, x0 + 1] * f


def _interp(field: np.ndarray, xs: np.ndarray) -> np.ndarray:
    """Linear interpolation of ``field`` [h, w] at left-x positions ``xs``,
    edge-clamped."""
    h, w = field.shape
    x0 = np.clip(np.floor(xs), 0, w - 1).astype(np.int64)
    f = np.clip(xs - x0, 0.0, 1.0).astype(np.float32)
    base = (np.arange(h, dtype=np.int64) * w)[:, None]
    flat = field.ravel()
    return flat[base + x0] * (1.0 - f) + flat[base + np.minimum(x0 + 1, w - 1)] * f


def _invert_warp(disp: np.ndarray, w: int, iters: int = 12, tol: float = 1e-3) -> np.ndarray:
    """``x(y, u)`` solving ``x − D(y, x) = u`` by fixed point, at most
    ``iters`` steps, stopping once no pixel moves by ``tol`` or more."""
    u = np.broadcast_to(np.arange(w, dtype=np.float32)[None, :], disp.shape)
    x = u + _interp(disp, u)
    for _ in range(iters):
        x, prev = u + _interp(disp, x), x
        if np.abs(x - prev).max() < tol:
            break
    return x


def render(name: str, h: int, w: int, dmax: int, seed: int):
    """``(left, right)`` f32 gray [h, w] of the scene ``name``."""
    if name != "box":
        raise ValueError(f"unknown scene {name!r}")
    rng = np.random.default_rng(seed + zlib.crc32(name.encode()) % 65536)
    yy = np.broadcast_to(np.arange(h, dtype=np.float32)[:, None] / max(h - 1, 1), (h, w))
    xx = np.broadcast_to(np.arange(w, dtype=np.float32)[None, :] / max(w - 1, 1), (h, w))
    d_lo, d_hi = 0.08 * dmax, 0.92 * dmax
    lo, hi = d_lo + 0.05 * (d_hi - d_lo), d_lo + 0.35 * (d_hi - d_lo)
    bg = (lo + (hi - lo) * xx + 0.08 * (d_hi - d_lo) * yy).astype(np.float32)
    m1 = np.zeros((h, w), bool)
    m1[int(0.18 * h): int(0.55 * h), int(0.22 * w): int(0.48 * w)] = True
    m2 = np.zeros((h, w), bool)
    m2[int(0.50 * h): int(0.88 * h), int(0.58 * w): int(0.86 * w)] = True
    layers = [(bg, None), (np.full((h, w), 0.50 * dmax, np.float32), m2),
              (np.full((h, w), 0.70 * dmax, np.float32), m1)]
    texs = [_smooth_noise(rng, h, _OS * (w + 8)) for _ in layers]
    xs_left = np.broadcast_to(np.arange(w, dtype=np.float32)[None, :] * _OS, (h, w))
    left = np.zeros((h, w), np.float32)
    right = np.zeros((h, w), np.float32)
    for (disp, mask), tex in zip(layers, texs):
        img = _sample_x(tex, xs_left)
        left = img if mask is None else np.where(mask, img, left)
        xk = _invert_warp(disp, w)
        sup = (xk >= 0.0) & (xk <= w - 1.0)
        if mask is not None:
            sup &= _interp(mask.astype(np.float32), xk) > 0.5
        right = np.where(sup, _sample_x(tex, xk * _OS), right)
    return left.astype(np.float32), right.astype(np.float32)

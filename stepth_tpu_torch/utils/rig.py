"""A calibrated, lens-distorted stereo rig looking at a textured plane: the
raw views, and the exact disparity and depth in the rectified frame
(host-side, NumPy).

The rig path (rectify, match, depth) is checked against this scene. Camera
1 is the world frame; camera 2 sees ``x_cam2 = R · x_cam1 + T``; the plane
is ``z_cam1 = depth``. Every raw pixel of a view is undistorted (the
inverse of ``ops.rectify.distort_normalized``, by fixed-point iteration),
cast as a ray onto the plane, and reads a seeded noise texture laid on the
plane (a random grid sampled bilinearly, one cell ``feature_px`` pixels
wide in the left view). The truth is the rectification's own: a rectified
left pixel sees the plane point ``X``, at depth ``Z_rect = X · v3`` along
the rectified z axis and at disparity ``f · B / Z_rect``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np


class PlaneRig(NamedTuple):
    left: np.ndarray  # u8[H, W, 3]: the raw (distorted) left view
    right: np.ndarray  # u8[H, W, 3]: the raw right view, ``right_gain`` as bright
    disparity: np.ndarray  # f32[H, W]: f·B/Z_rect at each rectified left pixel
    z_rect: np.ndarray  # f32[H, W]: the plane's depth along the rectified z axis


def _rectified_axes(R, T):
    """(R_new, c2) in f64: the rectified axes as rows (x along the baseline,
    y ⟂ the old z, z = x × y) and cam2's centre ``−Rᵀ T`` in cam1's frame."""
    R = np.asarray(R, np.float64)
    c2 = -R.T @ np.asarray(T, np.float64).reshape(3)
    v1 = c2 / np.linalg.norm(c2)
    v2 = np.cross([0.0, 0.0, 1.0], v1)
    v2 /= np.linalg.norm(v2)
    return np.stack([v1, v2, np.cross(v1, v2)]), c2


def undistort_normalized(xd: np.ndarray, dist, iters: int = 30) -> np.ndarray:
    """The normalized coords [..., 2] that Brown–Conrady distortion ``dist``
    = (k1, k2, p1, p2[, k3]) takes to ``xd``, by fixed-point iteration
    (f64; converges for the mild lenses of a stereo rig)."""
    d = np.zeros(5)
    d[: len(dist)] = np.asarray(dist, np.float64)
    k1, k2, p1, p2, k3 = d
    xd = np.asarray(xd, np.float64)
    x, y = xd[..., 0].copy(), xd[..., 1].copy()
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (xd[..., 0] - dx) / radial
        y = (xd[..., 1] - dy) / radial
    return np.stack([x, y], -1)


def plane_rig(h: int, w: int, K, R, T, dist1: Optional[tuple] = None,
              dist2: Optional[tuple] = None, depth: float = 5.0, feature_px: float = 3.5,
              right_gain: float = 0.85, seed: int = 0) -> PlaneRig:
    """Both raw views (RGB u8, the same intrinsics ``K`` without skew) of the
    textured plane, and the truth in the frame that ``rectify_maps(K, K, R,
    T, (h, w))`` makes."""
    K = np.asarray(K, np.float64)
    R = np.asarray(R, np.float64)
    T = np.asarray(T, np.float64).reshape(3)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    vv, uu = np.meshgrid(np.arange(h, dtype=np.float64), np.arange(w, dtype=np.float64),
                         indexing="ij")
    xd = np.stack([(uu - cx) / fx, (vv - cy) / fy], -1)

    def hits(dist, R_c, T_c):
        """Plane points (x, y) seen by the raw pixels of a camera at pose
        (R_c, T_c)."""
        xu = undistort_normalized(xd, dist) if dist is not None else xd
        ray = np.concatenate([xu, np.ones_like(xu[..., :1])], -1) @ R_c  # Rᵀ · ray
        origin = -R_c.T @ T_c
        s = (depth - origin[2]) / ray[..., 2]
        return origin[:2] + s[..., None] * ray[..., :2]

    p1 = hits(dist1, np.eye(3), np.zeros(3))
    p2 = hits(dist2, R, T)
    cell = feature_px * depth / fx
    lo = np.minimum(p1.reshape(-1, 2).min(0), p2.reshape(-1, 2).min(0)) - 2 * cell
    hi = np.maximum(p1.reshape(-1, 2).max(0), p2.reshape(-1, 2).max(0)) + 2 * cell
    nx, ny = (np.ceil((hi - lo) / cell).astype(int) + 2)
    grid = np.random.default_rng(seed).uniform(20.0, 235.0, (ny, nx))

    def texture(p):
        g = (p - lo) / cell
        i0 = np.floor(g).astype(int)
        f = g - i0
        gx, gy = i0[..., 0], i0[..., 1]
        fx_, fy_ = f[..., 0], f[..., 1]
        return ((1 - fy_) * ((1 - fx_) * grid[gy, gx] + fx_ * grid[gy, gx + 1])
                + fy_ * ((1 - fx_) * grid[gy + 1, gx] + fx_ * grid[gy + 1, gx + 1]))

    tint = np.array([1.0, 0.92, 0.84])

    def rgb(tex, gain):
        return np.clip(np.rint(tex[..., None] * tint * gain), 0, 255).astype(np.uint8)

    # truth at each rectified left pixel (K_new = K without skew)
    R_new, c2 = _rectified_axes(R, T)
    K_new = K.copy()
    K_new[0, 1] = 0.0
    rays = np.stack([uu, vv, np.ones_like(uu)], -1) @ np.linalg.inv(K_new @ R_new).T
    X = rays * (depth / rays[..., 2:3])
    z_rect = X @ R_new[2]
    disparity = K_new[0, 0] * np.linalg.norm(c2) / z_rect
    return PlaneRig(rgb(texture(p1), 1.0), rgb(texture(p2), right_gain),
                    disparity.astype(np.float32), z_rect.astype(np.float32))

"""Stereo rectification of a calibrated pinhole rig (twin of
``stepth_tpu/ops/rectify.py``).

Fusiello/Trucco/Verri's compact rectification: given ``x_cam2 = R · x_cam1
+ T`` and intrinsics K1/K2, one rectified frame has the baseline as its
x-axis, and each view is resampled through an inverse sample map (output
pixel → source pixel) that also folds in the lens distortion, so a view is
undistorted and rectified by one bilinear remap. Maps are made once per
rig; :func:`rectify_pair` warps every frame.

Everything is f32 on the device of the tensors given (arrays go to
``device=``, the card by default). :func:`remap_bilinear` is the plain version of kernel K11
(``ops.fused_remap``): the reference's ``map_coordinates(order=1,
mode="nearest")`` masked by the raw map's in-bounds test. The 3×3
products are written as broadcast sums, so no matrix product (and no TF32
setting) touches the maps.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from stepth_tpu_torch.match.dense import default_device, to_tensor


class RectifyMaps(NamedTuple):
    """Inverse sample maps and the rectified rig's constants, on one device."""

    map_left: torch.Tensor  # f32[H, W, 2]: (x, y) source coords in the left image
    map_right: torch.Tensor  # f32[H, W, 2]
    focal: torch.Tensor  # f32 scalar: rectified focal (px)
    baseline: torch.Tensor  # f32 scalar: rectified baseline (world units)
    K_new: torch.Tensor  # f32[3, 3]: shared rectified intrinsics


def _f32(x, device) -> torch.Tensor:
    return to_tensor(x, device).to(torch.float32)


def _mv(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``m @ v`` for a [3, 3] matrix and a [3] vector."""
    return (m * v[None, :]).sum(-1)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for [3, 3] matrices."""
    return (a[:, :, None] * b[None, :, :]).sum(1)


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.linalg.norm(v)


def _rectified_frame(R: torch.Tensor, T: torch.Tensor):
    """(R_new, c2): the rectified axes as rows (x along the baseline, y ⟂ the
    old z, z = x × y) and cam2's centre in cam1's frame, ``−Rᵀ T``."""
    c2 = -_mv(R.T, T)
    v1 = _normalize(c2)
    old_z = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float32, device=R.device)
    v2 = _normalize(torch.linalg.cross(old_z, v1))
    v3 = torch.linalg.cross(v1, v2)
    return torch.stack([v1, v2, v3]), c2


def _device_of(*xs, device=None):
    """``device`` if given, else that of the first tensor among ``xs``
    (None when there is none: ``to_tensor`` then asks for one)."""
    if device is not None:
        return device
    return next((x.device for x in xs if isinstance(x, torch.Tensor)), None)


def distort_normalized(xn: torch.Tensor, dist) -> torch.Tensor:
    """Brown–Conrady forward distortion of normalized coords ``xn`` [..., 2];
    ``dist`` = (k1, k2, p1, p2[, k3]). The maps need only this forward model
    (output pixel → distorted source pixel), no iterative undistortion."""
    d = _f32(dist, xn.device).reshape(-1)
    k1, k2, p1, p2 = d[0], d[1], d[2], d[3]
    k3 = d[4] if d.shape[0] > 4 else torch.zeros((), dtype=torch.float32, device=xn.device)
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def rectify_maps(K1, K2, R, T, image_shape: Tuple[int, int], K_new=None, dist1=None,
                 dist2=None, device=None) -> RectifyMaps:
    """Rectification maps for a calibrated rig.

    ``K1``/``K2``: [3, 3] pinhole intrinsics; ``R`` [3, 3], ``T`` [3]: the
    relative pose, ``x_cam2 = R · x_cam1 + T``; ``image_shape``: (H, W) of
    the rectified output; ``K_new``: shared rectified intrinsics (default K1
    with zero skew); ``dist1``/``dist2``: optional lens distortion (k1, k2,
    p1, p2[, k3]) per source camera, folded into the maps. The maps live on
    the device of the tensor inputs, or on ``device`` (the card by default)
    for arrays.

    After ``remap_bilinear(left, maps.map_left)`` and (right,
    ``map_right``), a world point lies on the same row in both outputs, at
    disparity ``focal · baseline / Z_rect``."""
    device = _device_of(K1, K2, R, T, device=device)
    K1, K2, R = _f32(K1, device), _f32(K2, device), _f32(R, device)
    T = _f32(T, device).reshape(3)
    dev = K1.device
    h, w = image_shape
    R_new, c2 = _rectified_frame(R, T)
    if K_new is None:
        K_new = K1.clone()
        K_new[0, 1] = 0.0
    K_new = _f32(K_new, dev)

    # output pixel → rectified-frame ray → source-camera ray → (distort) → px
    A_new_inv = torch.linalg.inv(_mm(K_new, R_new))
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")

    def src_map(Ki, Ri, dist):
        M = _mm(Ri, A_new_inv)
        q = [M[i, 0] * xx + M[i, 1] * yy + M[i, 2] for i in range(3)]
        xn = torch.stack([q[0] / q[2], q[1] / q[2]], dim=-1)
        if dist is not None:
            xn = distort_normalized(xn, dist)
        x, y = xn[..., 0], xn[..., 1]
        return torch.stack([Ki[i, 0] * x + Ki[i, 1] * y + Ki[i, 2] for i in range(2)], dim=-1)

    eye = torch.eye(3, dtype=torch.float32, device=dev)
    return RectifyMaps(
        map_left=src_map(K1, eye, dist1),
        map_right=src_map(K2, R, dist2),
        focal=K_new[0, 0].clone(),
        baseline=torch.linalg.norm(c2),
        K_new=K_new,
    )


def maps_from_arrays(map_left, map_right, focal, baseline, K_new, device=None) -> RectifyMaps:
    """:class:`RectifyMaps` from arrays, e.g. the fields of the JAX package's
    ``RectifyMaps`` (``maps_from_arrays(*(np.asarray(f) for f in ref_maps),
    device="cuda")``): a rig calibrated and mapped once elsewhere is carried
    across unchanged. ``device`` defaults to the card (``"cuda"``)."""
    device = default_device(device)

    def f32(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    return RectifyMaps(f32(map_left).contiguous(), f32(map_right).contiguous(),
                       f32(focal), f32(baseline), f32(K_new))


def remap_bilinear(img, map_xy, fill: float = 0.0) -> torch.Tensor:
    """Bilinear sample of ``img`` ([Hs, Ws] or [Hs, Ws, C]) at ``map_xy``
    f32[H, W, 2] ((x, y) source coordinates); out-of-image samples get
    ``fill``. K11's plain version (``fused_remap.remap_bilinear_fused``).

    The reference's ``map_coordinates(order=1, mode="nearest")``: with
    ``fy = y − ⌊y⌋`` and ``fx`` alike, out = ((1−fy)(1−fx))·v00 +
    ((1−fy)fx)·v01 + (fy(1−fx))·v10 + (fy·fx)·v11, added left to right, the
    +1 taps clamped to the last row/column (weight 0 there). A map entry is
    in the image when it is finite and inside [0, Ws−1] × [0, Hs−1], in
    f32; other entries are replaced by 0 before any index is formed."""
    img = img.to(torch.float32)
    x, y = map_xy[..., 0], map_xy[..., 1]
    hs, ws = img.shape[0], img.shape[1]
    inb = (x >= 0) & (x <= ws - 1) & (y >= 0) & (y <= hs - 1)
    zero = torch.zeros((), dtype=torch.float32, device=map_xy.device)
    x, y = torch.where(inb, x, zero), torch.where(inb, y, zero)
    x0f, y0f = torch.floor(x), torch.floor(y)
    fx, fy = x - x0f, y - y0f
    gx, gy = 1.0 - fx, 1.0 - fy
    x0, y0 = x0f.long(), y0f.long()
    x1, y1 = (x0 + 1).clamp(max=ws - 1), (y0 + 1).clamp(max=hs - 1)
    flat = img.reshape(hs * ws, -1)
    taps = [(gy * gx, y0, x0), (gy * fx, y0, x1), (fy * gx, y1, x0), (fy * fx, y1, x1)]
    out = None
    for wgt, yi, xi in taps:
        term = wgt[..., None] * flat[(yi * ws + xi).reshape(-1)].reshape(*wgt.shape, -1)
        out = term if out is None else out + term
    out = torch.where(inb[..., None], out, torch.full((), fill, dtype=torch.float32,
                                                      device=out.device))
    return out[..., 0] if img.ndim == 2 else out


def rectify_pair(left, right, maps: RectifyMaps, backend: str = "xla"):
    """Warp both views into the rectified frame (bilinear), as f32.

    ``left``/``right``: [H, W] or [H, W, C] tensors on the maps' device, or
    arrays (moved there). ``backend="xla"`` (the reference's default name)
    runs :func:`remap_bilinear` in torch; ``backend="pallas"`` runs kernel
    K11 (``fused_remap``) on CUDA tensors and its plain version on CPU
    tensors."""
    if backend not in ("xla", "pallas"):
        raise ValueError(f"backend must be 'xla' or 'pallas', got {backend!r}")
    device = maps.map_left.device
    left = to_tensor(left, device).to(torch.float32).contiguous()
    right = to_tensor(right, device).to(torch.float32).contiguous()
    if backend == "pallas":
        from stepth_tpu_torch.ops import fused_remap

        remap = fused_remap.remap_bilinear_fused
    else:
        remap = remap_bilinear
    return remap(left, maps.map_left), remap(right, maps.map_right)


def project_rectified(pts_cam1, maps: RectifyMaps, R, T):
    """Project cam1-frame points [..., 3] through both *rectified* cameras;
    returns (uv1, uv2) f32[..., 2]. Their rows are equal by construction."""
    pts = to_tensor(pts_cam1, maps.K_new.device).to(torch.float32)
    R = _f32(R, pts.device)
    T = _f32(T, pts.device).reshape(3)
    R_new, c2 = _rectified_frame(R, T)

    def rot(m, x):
        return (m * x[..., None, :]).sum(-1)

    def proj(x):
        q = rot(maps.K_new, x)
        return q[..., :2] / q[..., 2:3]

    return proj(rot(R_new, pts)), proj(rot(R_new, pts - c2))

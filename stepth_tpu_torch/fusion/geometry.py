"""SE(3) and pinhole camera geometry (twin of ``stepth_tpu/fusion/geometry.py``).

Conventions are the reference's:

* rotations as axis-angle 3-vectors (``so3``), poses as ``[rx, ry, rz, tx,
  ty, tz]`` 6-vectors (``se3``); ``T(x) = R x + t`` maps *world* points into
  the *camera* frame, with the translation part taken as it is (not the
  SE(3) exponential's V-matrix);
* pinhole intrinsics ``(fx, fy, cx, cy)``; pixel = ``(fx X/Z + cx, fy Y/Z +
  cy)``;
* f32, batched along leading axes; series fallbacks near θ = 0.

Products of 3×3 matrices and vectors are broadcast multiply-sums, as in the
reference, so no matrix-product precision setting touches them. Every
function works on the device of its tensor inputs.
"""

from __future__ import annotations

from typing import Tuple

import torch

from stepth_tpu_torch.match.dense import to_tensor

_EPS = 1e-8


def _like(x, ref: torch.Tensor) -> torch.Tensor:
    """``x`` as an f32 tensor on ``ref``'s device."""
    return to_tensor(x, ref.device).to(torch.float32)


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: w[..., 3] → skew matrix [..., 3, 3]."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], -1),
        torch.stack([wz, z, -wx], -1),
        torch.stack([-wy, wx, z], -1),
    ], -2)


def _matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 3×3 product as a broadcast multiply-sum."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: axis-angle [..., 3] → rotation matrix [..., 3, 3]."""
    theta2 = (w * w).sum(-1, keepdim=True)[..., None]
    theta = torch.sqrt(theta2 + _EPS)
    K = hat(w)
    K2 = _matmul3(K, K)
    small = theta2 < 1e-8  # sin θ/θ and (1 − cos θ)/θ² by their series near 0
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a * K + b * K2


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] → axis-angle [..., 3] (θ ∈ [0, π))."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos = torch.clamp((trace - 1.0) / 2.0, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(cos)
    w = torch.stack([
        R[..., 2, 1] - R[..., 1, 2],
        R[..., 0, 2] - R[..., 2, 0],
        R[..., 1, 0] - R[..., 0, 1],
    ], -1)
    sin = torch.sin(theta)
    scale = torch.where(theta[..., None] < 1e-6, 0.5,
                        theta[..., None] / (2.0 * sin[..., None] + _EPS))
    return w * scale


def exp_se3(xi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """se3 6-vector [..., 6] → (R [..., 3, 3], t [..., 3])."""
    return exp_so3(xi[..., :3]), xi[..., 3:]


def se3_from_Rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return torch.cat([log_so3(R), t], dim=-1)


def _rotate(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R·v as a broadcast multiply-sum."""
    return (R * v[..., None, :]).sum(-1)


def transform(xi: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply pose ``xi`` [..., 6] to points [..., 3]: R·p + t."""
    R, t = exp_se3(xi)
    return _rotate(R, pts) + t


def compose(xi_a: torch.Tensor, xi_b: torch.Tensor) -> torch.Tensor:
    """Pose of (a ∘ b): first apply b, then a."""
    Ra, ta = exp_se3(xi_a)
    Rb, tb = exp_se3(xi_b)
    return se3_from_Rt(_matmul3(Ra, Rb), _rotate(Ra, tb) + ta)


def inverse(xi: torch.Tensor) -> torch.Tensor:
    R, t = exp_se3(xi)
    Rt = R.transpose(-1, -2)
    return se3_from_Rt(Rt, -_rotate(Rt, t))


def relative(xi_a: torch.Tensor, xi_b: torch.Tensor) -> torch.Tensor:
    """T_a⁻¹ ∘ T_b."""
    return compose(inverse(xi_a), xi_b)


def project(pts_cam: torch.Tensor, intrinsics) -> torch.Tensor:
    """Camera-frame points [..., 3] → pixels [..., 2]; intrinsics [..., 4] =
    (fx, fy, cx, cy). |Z| < 1e-6 is replaced by 1e-6."""
    k = _like(intrinsics, pts_cam)
    fx, fy, cx, cy = k[..., 0], k[..., 1], k[..., 2], k[..., 3]
    z = pts_cam[..., 2]
    z = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    return torch.stack([fx * pts_cam[..., 0] / z + cx, fy * pts_cam[..., 1] / z + cy], -1)


def unproject(uv: torch.Tensor, depth: torch.Tensor, intrinsics) -> torch.Tensor:
    """Pixels [..., 2] + depth [...] → camera-frame points [..., 3]."""
    k = _like(intrinsics, depth)
    fx, fy, cx, cy = k[..., 0], k[..., 1], k[..., 2], k[..., 3]
    x = (uv[..., 0] - cx) / fx * depth
    y = (uv[..., 1] - cy) / fy * depth
    return torch.stack([x, y, depth], -1)


def disparity_to_depth(disp: torch.Tensor, focal, baseline) -> torch.Tensor:
    """Stereo disparity → metric depth: Z = f·B/d (d ≤ 1e-3 → 0).

    ``f·B`` is formed as the reference forms it: from Python numbers in
    double precision and then rounded to f32, from tensors in f32; it is
    then a tensor on the disparity's device, so that the division is a
    true f32 division on every device."""
    fb = torch.as_tensor(focal * baseline, dtype=torch.float32).to(disp.device)
    return torch.where(disp > 1e-3, fb / torch.clamp(disp, min=1e-3),
                       torch.zeros((), dtype=torch.float32, device=disp.device))


def depth_to_points(depth: torch.Tensor, intrinsics) -> torch.Tensor:
    """Depth image [H, W] → camera-frame point image [H, W, 3] (every pixel
    centre back-projected; :func:`stepth_tpu_torch.core.io.save_ply`
    writes it)."""
    h, w = depth.shape
    v, u = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=depth.device),
                          torch.arange(w, dtype=torch.float32, device=depth.device),
                          indexing="ij")
    return unproject(torch.stack([u, v], -1), depth, intrinsics)

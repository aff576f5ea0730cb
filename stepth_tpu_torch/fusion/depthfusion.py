"""Multi-keyframe depth fusion (twin of ``stepth_tpu/fusion/depthfusion.py``).

Fuses ``K`` posed depth maps into a reference view: each source depth map is
unprojected, moved into the reference camera and **forward splatted** with
a z-buffer; the warped depths are then blended where they agree within a
relative tolerance, giving a fused depth and a support-count confidence.

The reference's z-buffer is ``jax.ops.segment_min`` over flattened pixel
indices. Here it is ``scatter_reduce(..., "amin")`` into a buffer filled
with ``1e9`` with one overflow slot per view for the pixels that land
nowhere; all ``K`` views scatter in one call, view ``k`` at offset
``k·(H·W + 1)``. A minimum does not depend on the order of its operands,
so the scatter's atomics on the card give the same bits on every run, and
the same bits as the reference. ``torch.round`` rounds half to even, as
``jnp.round`` does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from stepth_tpu_torch.fusion import geometry as geo
from stepth_tpu_torch.match.dense import to_tensor

_FAR = 1e9


class FusedDepth(NamedTuple):
    depth: torch.Tensor  # f32[H, W]; 0 where nothing fused
    confidence: torch.Tensor  # f32[H, W]; number of agreeing views


def _f32(x, device) -> torch.Tensor:
    return to_tensor(x, device).to(torch.float32)


def _warp(depths: torch.Tensor, poses: torch.Tensor, ref_pose: torch.Tensor,
          intrinsics: torch.Tensor) -> torch.Tensor:
    """Forward-splat each of ``depths`` [K, H, W] (world→source ``poses``
    [K, 6]) into the reference view: [K, H, W], 0 where nothing lands."""
    k, h, w = depths.shape
    dev = depths.device
    ys, xs = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev),
                            indexing="ij")
    uv = torch.stack([xs, ys], -1).to(torch.float32).reshape(-1, 2)
    z = depths.reshape(k, -1)

    pts_src = geo.unproject(uv, z, intrinsics)  # [K, H·W, 3]
    src_to_ref = geo.compose(ref_pose, geo.inverse(poses))  # [K, 6]
    pts_ref = geo.transform(src_to_ref[:, None], pts_src)
    uv_ref = geo.project(pts_ref, intrinsics)
    z_ref = pts_ref[..., 2]

    # the reference compares the rounded coordinates as int32; comparing
    # them as floats is the same for every finite value and leaves NaN out
    px = torch.round(uv_ref[..., 0])
    py = torch.round(uv_ref[..., 1])
    valid = (z > 1e-3) & (z_ref > 1e-3) & (px >= 0) & (px < w) & (py >= 0) & (py < h)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    flat = (torch.where(valid, py, zero).to(torch.int64) * w
            + torch.where(valid, px, zero).to(torch.int64))
    hw = h * w
    base = torch.arange(k, device=dev)[:, None] * (hw + 1)
    idx = base + torch.where(valid, flat, hw)  # invalid → the view's overflow slot
    z_scatter = torch.where(valid, z_ref, _FAR)

    zbuf = torch.full((k * (hw + 1),), _FAR, dtype=torch.float32, device=dev)
    zbuf.scatter_reduce_(0, idx.reshape(-1), z_scatter.reshape(-1), "amin", include_self=True)
    zbuf = zbuf.reshape(k, hw + 1)[:, :hw]
    return torch.where(zbuf >= _FAR, zero, zbuf).reshape(k, h, w)


def warp_depth_to_ref(src_depth, src_pose, ref_pose, intrinsics, device=None) -> torch.Tensor:
    """Forward-splat a source depth map f32[H, W] (world→source pose
    ``src_pose`` [6]) into the reference view (world→reference ``ref_pose``,
    shared ``intrinsics`` (fx, fy, cx, cy)). Returns f32[H, W] of
    reference-frame depths, 0 where no source pixel lands; collisions keep
    the nearest surface. Arrays go to ``device`` (the card by default)."""
    src_depth = _f32(src_depth, device)
    dev = src_depth.device
    return _warp(src_depth[None], _f32(src_pose, dev)[None], _f32(ref_pose, dev),
                 _f32(intrinsics, dev))[0]


def fuse_depths(depths, poses, ref_pose, intrinsics, rel_tol: float = 0.02,
                device=None) -> FusedDepth:
    """Warp every source view of ``depths`` [K, H, W] (poses [K, 6]) into the
    reference camera and blend: the nearest warped depth is the anchor, the
    views within ``rel_tol`` (relative) of it are averaged, and the
    confidence is how many there are."""
    depths = _f32(depths, device)
    dev = depths.device
    warped = _warp(depths, _f32(poses, dev), _f32(ref_pose, dev), _f32(intrinsics, dev))
    has = warped > 0.0
    anchor = torch.where(has, warped, _FAR).amin(0)  # nearest surface
    agree = has & (torch.abs(warped - anchor[None]) <= rel_tol * anchor[None])
    count = agree.sum(0).to(torch.float32)
    # the reference's reduction over views: one add per view, in view order
    total = torch.zeros_like(anchor)
    for view, ok in zip(warped, agree):
        total = total + torch.where(ok, view, 0.0)
    fused = torch.where(count > 0, total / torch.clamp(count, min=1.0), 0.0)
    return FusedDepth(depth=fused, confidence=count)

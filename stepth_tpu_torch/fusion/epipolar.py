"""Two-view epipolar geometry (twin of ``stepth_tpu/fusion/epipolar.py``):
essential-matrix estimation, pose recovery and linear triangulation, as
batched SVDs and small products.

It completes the uncalibrated-extrinsics flow: matched correspondences →
:func:`estimate_essential` → :func:`recover_pose` →
:func:`stepth_tpu_torch.ops.rectify.rectify_maps` → the dense matchers.

Conventions are :mod:`stepth_tpu_torch.ops.rectify`'s and
:mod:`.geometry`'s: ``x_cam2 = R · x_cam1 + T``; the inputs here are
*normalised* image coordinates (``K⁻¹ · pixel``). Singular vectors carry an
arbitrary sign, so ``E`` is defined up to sign (and scale); the pair
{R1, R2} and ±t that :func:`recover_pose` chooses from do not depend on it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from stepth_tpu_torch.fusion import ba, geometry as geo
from stepth_tpu_torch.match.dense import to_tensor


def _f32(x, device) -> torch.Tensor:
    return to_tensor(x, device).to(torch.float32)


def _homogeneous(xn: torch.Tensor) -> torch.Tensor:
    return torch.cat([xn, torch.ones_like(xn[..., :1])], -1)


def _apply(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """m · xᵢ for each row xᵢ of ``x`` [..., N, 3] (m [..., 3, 3])."""
    return x @ m.transpose(-1, -2)


def estimate_essential(x1n, x2n) -> torch.Tensor:
    """Normalised eight-point essential matrix from N ≥ 8 correspondences in
    normalised coordinates ([..., N, 2] each; leading dims batch several
    problems): Hartley isotropic scaling, the least-squares null vector,
    then the projection onto the essential manifold (singular values
    (σ, σ, 0)). Satisfies ``x2ᵀ E x1 = 0``."""
    x1 = _homogeneous(x1n)
    x2 = _homogeneous(x2n)

    def normalize(x):
        mean = x[..., :2].mean(-2)  # [..., 2]
        spread = torch.linalg.vector_norm(x[..., :2] - mean[..., None, :], dim=-1).mean(-1)
        # a true division (torch computes number / tensor by a reciprocal)
        scale = spread.new_tensor(np.sqrt(2.0)) / torch.clamp(spread, min=1e-12)
        tf = torch.zeros(x.shape[:-2] + (3, 3), dtype=x.dtype, device=x.device)
        tf[..., 0, 0] = scale
        tf[..., 1, 1] = scale
        tf[..., 2, 2] = 1.0
        tf[..., 0, 2] = -scale * mean[..., 0]
        tf[..., 1, 2] = -scale * mean[..., 1]
        return _apply(tf, x), tf

    p1, t1 = normalize(x1)
    p2, t2 = normalize(x2)
    # x2ᵀ E x1 = 0 → A · vec(E) = 0 with rows kron(x2, x1)
    a = (p2[..., :, None] * p1[..., None, :]).reshape(p1.shape[:-1] + (9,))
    vt = torch.linalg.svd(a, full_matrices=True)[2]
    e = vt[..., -1, :].reshape(vt.shape[:-2] + (3, 3))
    e = t2.transpose(-1, -2) @ e @ t1  # denormalise
    u, s, vt = torch.linalg.svd(e)
    sigma = (s[..., 0] + s[..., 1]) / 2.0
    diag = torch.stack([sigma, sigma, torch.zeros_like(sigma)], -1)
    return (u * diag[..., None, :]) @ vt


def triangulate(R, T, x1n, x2n) -> torch.Tensor:
    """Linear (DLT) triangulation of normalised correspondences under
    ``x_cam2 = R x_cam1 + T``; returns cam1-frame points [N, 3]."""
    x1n = to_tensor(x1n)
    dev = x1n.device
    x2n = to_tensor(x2n, dev)
    R = _f32(R, dev)
    T = _f32(T, dev).reshape(3)
    P1 = torch.cat([torch.eye(3, dtype=torch.float32, device=dev),
                    torch.zeros((3, 1), dtype=torch.float32, device=dev)], 1)
    P2 = torch.cat([R, T[:, None]], 1)
    rows = torch.stack([
        x1n[:, 0, None] * P1[2] - P1[0],
        x1n[:, 1, None] * P1[2] - P1[1],
        x2n[:, 0, None] * P2[2] - P2[0],
        x2n[:, 1, None] * P2[2] - P2[1],
    ], 1)  # [N, 4, 4]
    X = torch.linalg.svd(rows)[2][:, -1]
    return X[:, :3] / X[:, 3:]


def recover_pose(E, x1n, x2n) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decompose ``E`` into the physically valid ``(R, T̂)`` (unit-norm
    translation: the global scale is unobservable from two views) by the
    cheirality test: the candidate placing the most triangulated points in
    front of both cameras wins. Returns ``(R, T_unit, points_cam1)``."""
    x1n = to_tensor(x1n)
    E = _f32(E, x1n.device)
    u, _, vt = torch.linalg.svd(E)
    # proper rotations
    u = u * torch.sign(torch.linalg.det(u))
    vt = vt * torch.sign(torch.linalg.det(vt))
    w = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=torch.float32, device=E.device)
    R1 = u @ w @ vt
    R2 = u @ w.T @ vt
    t = u[:, 2]
    cands = [(R1, t), (R1, -t), (R2, t), (R2, -t)]
    scores, points = [], []
    for R, T in cands:
        X1 = triangulate(R, T, x1n, x2n)
        X2 = _apply(R, X1) + T
        scores.append(((X1[:, 2] > 0) & (X2[:, 2] > 0)).sum())
        points.append(X1)
    best = torch.stack(scores).argmax()
    return (torch.stack([c[0] for c in cands])[best], torch.stack([c[1] for c in cands])[best],
            torch.stack(points)[best])


def epipolar_residuals(E, x1n, x2n) -> torch.Tensor:
    """Sampson-normalised epipolar distances |x2ᵀEx1| / ‖gradient‖ — the
    first-order geometric residual for inlier scoring ([..., N] for
    ``E`` [..., 3, 3])."""
    h1 = _homogeneous(x1n)
    h2 = _homogeneous(x2n)
    Eh1 = _apply(E, h1)  # [..., N, 3]
    Eth2 = _apply(E.transpose(-1, -2), h2)
    num = torch.abs((h2 * Eh1).sum(-1))
    den = torch.sqrt(Eh1[..., 0] ** 2 + Eh1[..., 1] ** 2 + Eth2[..., 0] ** 2 + Eth2[..., 1] ** 2)
    return num / torch.clamp(den, min=1e-12)


def ransac_essential(x1n, x2n, iters: int = 256, thresh: float = 2.5e-3,
                     seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """RANSAC eight-point: all ``iters`` minimal hypotheses estimated by one
    batched eight-point solve and scored by one batched Sampson pass.
    Returns ``(E, inlier_mask)``, ``E`` re-estimated on the consensus set.

    Each hypothesis draws 8 distinct correspondences from a CPU
    ``torch.Generator`` seeded with ``seed`` (the first 8 of a random
    permutation per hypothesis), so every device draws the same samples;
    the reference draws them from JAX's threefry, which torch cannot
    reproduce. ``thresh`` is in normalised coordinates (a pixel tolerance
    over the focal length)."""
    x1n = to_tensor(x1n)
    x2n = to_tensor(x2n, x1n.device)
    n = x1n.shape[0]
    if n < 8:
        return estimate_essential(x1n, x2n), torch.ones(n, dtype=torch.bool, device=x1n.device)
    gen = torch.Generator().manual_seed(seed)
    idx = torch.rand(iters, n, generator=gen).argsort(-1)[:, :8].to(x1n.device)
    Es = estimate_essential(x1n[idx], x2n[idx])  # [iters, 3, 3]
    resid = epipolar_residuals(Es, x1n, x2n)  # [iters, N]
    best = (resid < thresh).sum(1).argmax()
    mask = resid[best] < thresh
    # refit on the consensus set (its size is data-dependent: a host sync)
    if int(mask.sum()) >= 8:
        return estimate_essential(x1n[mask], x2n[mask]), mask
    return Es[best], torch.ones(n, dtype=torch.bool, device=x1n.device)


def refine_pose_ba(uv1, uv2, K, R0, T0, X0, iters: int = 15, cg_iters: int = 10,
                   loss: str = "huber", loss_delta: float = 1.0, weights=None, device=None):
    """Two-view refinement: the triangulated structure and the eight-point
    pose start a robust bundle adjustment over {cam2 pose, points} (cam1
    fixed: the gauge). Returns ``(R, T_unit, points_cam1)`` on the device of
    ``uv1`` (an array goes to ``device``, the card by default)."""
    uv1 = _f32(uv1, device)
    dev = uv1.device
    K = _f32(K, dev)
    n = uv1.shape[0]
    w0 = geo.log_so3(_f32(R0, dev))
    pose2 = torch.cat([w0, _f32(T0, dev).reshape(3)])
    poses0 = torch.stack([torch.zeros(6, dtype=torch.float32, device=dev), pose2])
    intr = torch.stack([K[0, 0], K[1, 1], K[0, 2], K[1, 2]])
    prob = ba.BAProblem(
        poses=poses0,
        points=_f32(X0, dev),
        intrinsics=intr,
        cam_idx=torch.cat([torch.zeros(n, dtype=torch.int32, device=dev),
                           torch.ones(n, dtype=torch.int32, device=dev)]),
        pt_idx=torch.arange(n, dtype=torch.int32, device=dev).repeat(2),
        uv=torch.cat([uv1, _f32(uv2, dev)]),
        weight=(torch.ones(2 * n, dtype=torch.float32, device=dev) if weights is None
                else _f32(weights, dev).repeat(2)),
    )
    st = ba.solve(prob, iters=iters, cg_iters=cg_iters, loss=loss, loss_delta=loss_delta)
    R = geo.exp_so3(st.poses[1, :3])
    t = st.poses[1, 3:]
    return R, t / torch.linalg.vector_norm(t), st.points


def pose_from_correspondences(uv1, uv2, K1, K2, trim_iters: int = 0, keep: float = 0.7,
                              refine: bool = True, ransac_iters: int = 256,
                              ransac_px: float = 2.0, seed: int = 0, device=None):
    """Pixels → relative pose: normalise by the intrinsics, RANSAC eight-point
    (``ransac_iters`` batched hypotheses, ``ransac_px`` pixel inlier
    tolerance), the cheirality decomposition on the consensus set, then
    (``refine=True``, the default) robust two-view bundle adjustment with
    the outliers weighted 0. Returns ``(R, T_unit, points_cam1)``: feed
    ``(R, T_unit · b)`` to :func:`stepth_tpu_torch.ops.rectify.rectify_maps`
    with a known baseline ``b`` for metric depth. Arrays go to ``device``
    (the card by default), or to the device of ``uv1`` if it is a tensor.

    RANSAC rejects gross outliers (repetitive-texture false matches), then
    huber IRLS in the bundle adjustment handles the sub-pixel tail;
    ``ransac_iters=0`` is the plain least-squares eight-point. Trimmed
    re-estimation (``trim_iters`` > 0) is off by default: trimming against
    a biased eight-point fit discards the high-parallax correspondences
    that carry the translation. The refinement needs shared intrinsics
    (K1 == K2) and is skipped otherwise."""
    uv1 = _f32(uv1, device)
    dev = uv1.device
    uv2 = _f32(uv2, dev)
    K1 = _f32(K1, dev)
    K2 = _f32(K2, dev)
    x1 = _apply(torch.linalg.inv(K1), _homogeneous(uv1))
    x2 = _apply(torch.linalg.inv(K2), _homogeneous(uv2))
    x1n = x1[:, :2] / x1[:, 2:3]
    x2n = x2[:, :2] / x2[:, 2:3]
    inlier = torch.ones(x1n.shape[0], dtype=torch.bool, device=dev)
    if ransac_iters > 0:
        focal = float(K1[0, 0] + K1[1, 1] + K2[0, 0] + K2[1, 1]) / 4.0
        E, inlier = ransac_essential(x1n, x2n, iters=ransac_iters, thresh=ransac_px / focal,
                                     seed=seed)
    else:
        E = estimate_essential(x1n, x2n)
    x1k, x2k = x1n, x2n
    for _ in range(trim_iters):
        r = epipolar_residuals(E, x1k, x2k).cpu().numpy()
        if len(r) * keep < 8:
            break
        sel = torch.as_tensor(r <= np.quantile(r, keep), device=dev)
        x1k, x2k = x1k[sel], x2k[sel]
        E = estimate_essential(x1k, x2k)
    R, T, _ = recover_pose(E, x1n[inlier], x2n[inlier])
    X = triangulate(R, T, x1n, x2n)
    if refine and torch.allclose(K1, K2):
        # refine on the full set with the outliers weighted 0; huber IRLS
        # gates the sub-pixel tail among the inliers
        R, T, X = refine_pose_ba(uv1, uv2, K1, R, T, X, weights=inlier.to(torch.float32))
    return R, T, X

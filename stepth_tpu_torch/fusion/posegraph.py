"""Pose-graph optimization over SE(3) (twin of ``stepth_tpu/fusion/posegraph.py``).

Nodes are keyframe poses [M, 6]; edges carry relative-pose measurements
Z_ij ≈ T_i⁻¹ ∘ T_j with scalar weights. The residual of an edge is the
6-vector of Z_ij⁻¹ ∘ (T_i⁻¹ ∘ T_j), zero when the measurement holds.
Solved by damped Gauss–Newton on the full (small, dense) normal system:
``torch.func.jacfwd`` of the flattened residual, ``J``ᵀ``J`` and ``J``ᵀ``r``
as full-f32 products (the reference asks for ``precision=HIGHEST``) and
``torch.linalg.solve_ex``; a Python loop stands in for ``fori_loop``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from stepth_tpu_torch.fusion import geometry as geo
from stepth_tpu_torch.fusion.ba import matmul_f32
from stepth_tpu_torch.match.dense import to_tensor

LOSSES = ("l2", "huber", "cauchy")


class PoseGraph(NamedTuple):
    poses: torch.Tensor  # f32[M, 6]
    edge_i: torch.Tensor  # i32[E]
    edge_j: torch.Tensor  # i32[E]
    measurements: torch.Tensor  # f32[E, 6] relative poses Z_ij
    weights: torch.Tensor  # f32[E]


def graph_from_arrays(fields: Dict[str, np.ndarray], device=None) -> PoseGraph:
    """A :class:`PoseGraph` from the fields of the JAX package's (its
    ``_asdict()``, as arrays), on ``device`` (the card by default)."""
    return PoseGraph(**{k: to_tensor(np.array(v), device) for k, v in fields.items()})


def edge_residuals(graph: PoseGraph, poses: torch.Tensor) -> torch.Tensor:
    """Weighted tangent-space residuals f32[E, 6]."""
    rel = geo.relative(poses[graph.edge_i], poses[graph.edge_j])
    err = geo.compose(geo.inverse(graph.measurements), rel)
    return err * graph.weights[:, None]


def optimize(graph: PoseGraph, iters: int = 10, damping: float = 1e-4,
             fix_first: bool = True, loss: str = "l2",
             loss_delta: float = 0.1) -> torch.Tensor:
    """Damped Gauss–Newton; returns the optimized poses f32[M, 6]. Node 0 is
    frozen when ``fix_first`` (the gauge).

    ``loss``: ``"l2"`` (default), ``"huber"`` or ``"cauchy"`` with
    tangent-space scale ``loss_delta``: IRLS edge reweighting per step, the
    defence against a false loop closure (under l2 a wrong edge warps the
    whole trajectory; huber bounds its influence, cauchy redescends to ~0)."""
    if loss not in LOSSES:
        raise ValueError(f"loss must be 'l2', 'huber' or 'cauchy', got {loss!r}")
    m = graph.poses.shape[0]
    dim = m * 6
    dev, dt = graph.poses.device, graph.poses.dtype
    mask = torch.cat([torch.zeros(6, dtype=dt, device=dev), torch.ones(dim - 6, dtype=dt, device=dev)])
    eye = torch.eye(dim, dtype=dt, device=dev)

    def res_flat(pose_flat, g):
        return edge_residuals(g, pose_flat.reshape(m, 6)).reshape(-1)

    poses = graph.poses
    for _ in range(iters):
        g = graph
        if loss != "l2":
            rw = edge_residuals(graph, poses)  # weighted [E, 6]
            s = torch.sqrt((rw * rw).sum(-1) + 1e-12)
            if loss == "huber":
                # a true division (torch computes number / tensor by a reciprocal)
                omega = torch.clamp(s.new_tensor(loss_delta) / s, max=1.0)
            else:
                omega = 1.0 / (1.0 + (s / loss_delta) ** 2)
            g = graph._replace(weights=graph.weights * torch.sqrt(omega))
        flat = poses.reshape(-1)
        r = res_flat(flat, g)
        J = torch.func.jacfwd(lambda p: res_flat(p, g))(flat)  # [E·6, M·6]
        if fix_first:
            J = J * mask[None, :]
        H = matmul_f32(J.T, J) + damping * eye
        step = torch.linalg.solve_ex(H, matmul_f32(J.T, r))[0]
        if fix_first:
            step = torch.where(mask > 0, step, 0.0)
        poses = (flat - step).reshape(m, 6)
    return poses


def total_error(graph: PoseGraph, poses: torch.Tensor) -> torch.Tensor:
    r = edge_residuals(graph, poses)
    return (r * r).sum()

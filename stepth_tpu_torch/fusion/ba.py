"""Schur-complement bundle adjustment (twin of ``stepth_tpu/fusion/ba.py``).

Levenberg–Marquardt over camera poses [C, 6] and world points [P, 3] with
reprojection residuals, each step solved by **implicit-Schur CG**:

* Jacobian blocks per observation, A = ∂r/∂pose [N, 2, 6] and
  B = ∂r/∂point [N, 2, 3], by ``torch.func.vmap`` of ``torch.func.jacfwd``
  on the single-observation residual (forward-mode AD, as the reference's
  ``jax.jacfwd``; the two libraries' derivatives agree to a few ulp, not
  bit for bit).
* Hessian blocks by segment sums: U_c = Σ AᵀA, V_p = Σ BᵀB, W = AᵀB per
  observation.
* The reduced camera system S·x = b (S = U − W V⁻¹ Wᵀ) is solved by CG; each
  S·x is two segment sums and small per-observation products, so S is
  never formed and a CG iteration costs O(N).
* **Sharding** (:func:`solve_sharded`): observations split over the mesh's
  ``data`` shards, in order; poses and points are replicated, and every
  segment sum and cost is computed per shard and summed on the mesh's first
  device in shard order (the reference's ``psum``). Over a mesh that spans
  processes each process computes the partials of the shards it owns; an
  ordered all-gather (``distributed.all_gather_ordered``) hands every
  process every shard's partial, and each sums them in shard order on its
  first device. So every process holds the same replicated state, equal
  bit for bit to the one-process solve on a mesh of the same shape: the
  LM accept test then decides alike everywhere, and every process runs the
  same sequence of collectives.

The LM and CG loops are Python loops with no host synchronisation inside
(within one process): the accept test, λ and the state stay tensors
combined by ``torch.where``. Across processes under gloo every sum of
partials is a host round trip (the partials staged through host memory).
Every reduction is deterministic (see :func:`_segsum`), so a solve gives
the same bits on every run on the same device, and a solve split into
segments continues bit for bit (:mod:`stepth_tpu_torch.fusion.resumable`).
All shapes are fixed; a padded observation slot has weight 0.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from stepth_tpu_torch.fusion import geometry
from stepth_tpu_torch.match.dense import to_tensor
from stepth_tpu_torch.parallel import distributed

LOSSES = ("l2", "huber", "cauchy")


class BAProblem(NamedTuple):
    """A fixed-size bundle-adjustment problem (pad + mask to resize)."""

    poses: torch.Tensor  # f32[C, 6] se3 world→camera
    points: torch.Tensor  # f32[P, 3]
    intrinsics: torch.Tensor  # f32[4] shared (fx, fy, cx, cy)
    cam_idx: torch.Tensor  # i32[N]
    pt_idx: torch.Tensor  # i32[N]
    uv: torch.Tensor  # f32[N, 2] observed pixels
    weight: torch.Tensor  # f32[N] (0 masks a padded slot)


class BAState(NamedTuple):
    poses: torch.Tensor
    points: torch.Tensor
    cost: torch.Tensor  # scalar mean squared reprojection error (weighted)
    lm_lambda: torch.Tensor


def problem_from_arrays(fields: Dict[str, np.ndarray], device=None) -> BAProblem:
    """A :class:`BAProblem` from the fields of the JAX package's (its
    ``_asdict()``, as arrays), on ``device`` (the card by default)."""
    return BAProblem(**{k: to_tensor(np.array(v), device) for k, v in fields.items()})


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in full f32. The reference asks for ``precision=HIGHEST``:
    a float32 matmul precision below ``"highest"`` (TF32 on the card, bf16
    passes on the CPU) would change the normal equations, so it raises."""
    if a.dtype == torch.float32 and torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError("bundle adjustment needs full-f32 products: "
                           "torch.set_float32_matmul_precision('highest')")
    return torch.matmul(a, b)


def _residual_one(pose, point, intr, uv):
    return geometry.project(geometry.transform(pose, point), intr) - uv


# The one-hot product of the reference, while the one-hot matrix stays small;
# past either limit the sorted reduction. The reference switches at 8192
# segments; the element limit (64 MB of f32) keeps the mapping problem's
# points (32,768 observations × 4,096 points would be a 512 MB one-hot for
# every segment sum) on the sorted path. Each route is the faster one where
# it is taken: on an H100 (700 W, chip_smoke.py phase 7a) 32,768 rows sum
# into 8 cameras in 0.022 ms one-hot against 0.23-0.27 ms sorted (a thread
# adds each segment's 4,096 rows one after another), and into 4,096 points
# in 0.91 ms one-hot against 0.014-0.034 ms sorted.
_ONEHOT_MAX_SEGMENTS = 8192
_ONEHOT_MAX_ELEMENTS = 1 << 24


class _Segments(NamedTuple):
    """An index set prepared once per problem for :func:`_segsum`."""

    idx: torch.Tensor  # [N] segment of each row
    num: int  # number of segments
    order: Optional[torch.Tensor]  # rows sorted by segment (stable); None: one-hot
    lengths: Optional[torch.Tensor]  # rows per segment


def _segments(idx: torch.Tensor, num_segments: int) -> _Segments:
    """Prepare ``idx`` for :func:`_segsum`: the sorted path's stable order
    and segment lengths, computed once (``bincount`` waits for the device)."""
    if (num_segments <= _ONEHOT_MAX_SEGMENTS
            and idx.shape[0] * num_segments <= _ONEHOT_MAX_ELEMENTS):
        return _Segments(idx, num_segments, None, None)
    order = torch.argsort(idx, stable=True)
    return _Segments(idx, num_segments, order, torch.bincount(idx, minlength=num_segments))


def _segsum(x: torch.Tensor, idx: torch.Tensor, num_segments: int,
            seg: Optional[_Segments] = None) -> torch.Tensor:
    """Segment sum of the rows of ``x`` by ``idx``, exact f32 and
    deterministic on every device (``seg`` from :func:`_segments`, made here
    if not given).

    ``index_add_``/``scatter_add_`` on the card add with atomics in no fixed
    order, so a sum could differ in its last bits from run to run, and a
    resumed solve would no longer continue bit for bit. Instead:

    * few segments: the reference's one-hot product, a full-f32 matmul (the
      products are exact; the library's summation order is fixed for a
      shape on a device);
    * many: the rows sorted once by segment (a stable sort keeps each
      segment's rows in their order) and ``torch.segment_reduce``, which
      adds each segment's rows one after another."""
    if seg is None:
        seg = _segments(idx, num_segments)
    flat = x.reshape(x.shape[0], -1)
    if seg.order is None:
        oh = (idx[:, None] == torch.arange(num_segments, dtype=idx.dtype,
                                           device=idx.device)[None, :]).to(flat.dtype)
        out = matmul_f32(oh.T, flat)
    else:
        out = torch.segment_reduce(flat[seg.order], "sum", lengths=seg.lengths, axis=0,
                                   unsafe=True)
    return out.reshape((num_segments,) + tuple(x.shape[1:]))


def _inv3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form adjugate inverse of batched 3×3 blocks."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = f * g - d * i
    C = d * h - e * g
    D = c * h - b * i
    E = a * i - c * g
    F = b * g - a * h
    G = b * f - c * e
    H = c * d - a * f
    I = a * e - b * d  # noqa: E741
    det = a * A + b * B + c * C
    adj = torch.stack([
        torch.stack([A, D, G], -1),
        torch.stack([B, E, H], -1),
        torch.stack([C, F, I], -1),
    ], -2)
    return adj / det[..., None, None]


def _inv_spd(m: torch.Tensor) -> torch.Tensor:
    """Batched SPD inverse by Cholesky (``cholesky_ex``: a block that is not
    positive definite gives NaN, as in the reference, and no host sync)."""
    chol = torch.linalg.cholesky_ex(m)[0]
    eye = torch.eye(m.shape[-1], dtype=m.dtype, device=m.device).expand(m.shape)
    return torch.cholesky_solve(eye, chol)


def residuals(problem: BAProblem, poses: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Weighted reprojection residuals f32[N, 2]."""
    r = _residual_one(poses[problem.cam_idx], points[problem.pt_idx], problem.intrinsics,
                      problem.uv)
    return r * problem.weight[:, None]


def _jacobian_blocks(problem: BAProblem, poses, points):
    """Per-observation r [N, 2], A [N, 2, 6], B [N, 2, 3] (weighted)."""
    intr = problem.intrinsics

    def one(pose, point, uv):
        r = _residual_one(pose, point, intr, uv)
        return r, r

    (A, B), r = torch.func.vmap(torch.func.jacfwd(one, argnums=(0, 1), has_aux=True))(
        poses[problem.cam_idx], points[problem.pt_idx], problem.uv)
    wgt = problem.weight
    return r * wgt[:, None], A * wgt[:, None, None], B * wgt[:, None, None]


# Per-observation products as broadcast multiply-sums, as the reference
# writes them (exact f32, no matmul precision involved).
def _outer(a, b):  # Σ_k a[n,k,i]·b[n,k,j] → [N,i,j]
    return (a[:, :, :, None] * b[:, :, None, :]).sum(1)


def _matvec_t(m, v):  # Σ_i m[n,i,j]·v[n,i] → [N,j]
    return (m * v[:, :, None]).sum(1)


def _matvec(m, v):  # Σ_j m[n,i,j]·v[n,j] → [N,i]
    return (m * v[:, None, :]).sum(2)


class _Shard(NamedTuple):
    """One shard of the observations, with its index sets prepared."""

    problem: BAProblem
    cams: _Segments
    pts: _Segments


def _allsum(parts: Sequence[torch.Tensor], dev: torch.device,
            owners: Optional[Sequence[int]] = None, like=None) -> torch.Tensor:
    """The per-shard partials summed on ``dev`` in shard order (the
    reference's ``psum``; one shard: the partial itself). ``owners`` (the
    process of each shard; None: all this one's) makes ``parts`` this
    process's shards only (possibly none), each of ``like``'s ``(shape,
    dtype)``, gathered from every process first. Else every partial after
    the first (which lies on ``dev``) is a ``gather`` move of the traffic
    tally."""
    if owners is not None:
        parts = distributed.all_gather_ordered(parts, owners, dev, like)
    else:
        for p in parts[1:]:
            distributed.traffic.move("gather", p.numel() * p.element_size())
    out = parts[0].to(dev)
    for p in parts[1:]:
        out = out + p.to(dev)
    return out


def _schur_system(shards: Sequence[_Shard], blocks, lm_lambda: torch.Tensor, dims,
                  owners: Optional[Sequence[int]] = None):
    """The implicit reduced camera system over ``shards`` (with their
    ``blocks`` ``(r, A, B)``; ``dims``: the cameras, the points and the
    state's dtype; ``owners`` as in :func:`_allsum`):
    ``(S_apply, precond, b, back_substitute)``,
    where ``S_apply(x)`` applies S = U − W V⁻¹ Wᵀ without forming it,
    ``precond`` is the block-Jacobi diag(U_d)⁻¹, ``b`` the Schur right-hand
    side and ``back_substitute(dpose)`` recovers Δpoints. Everything
    replicated lives on ``lm_lambda``'s device."""
    dev = lm_lambda.device
    C, Pn, dtype = dims

    def segsum(parts, which, width):  # [N, width] per shard → [C or P, width]
        num = C if which == "cams" else Pn
        return _allsum([_segsum(x, getattr(s, which).idx, getattr(s, which).num,
                                getattr(s, which)) for x, s in zip(parts, shards)], dev,
                       owners, ((num, width), dtype))

    def local(x):  # a replicated value on each shard's device
        return [x.to(s.problem.uv.device) for s in shards]

    # Hessian blocks + gradients: one segment sum per side, [N,42]→C, [N,12]→P
    cam_red = segsum([torch.cat([_outer(A, A).reshape(-1, 36), _matvec_t(A, r)], 1)
                      for r, A, _ in blocks], "cams", 42)
    pt_red = segsum([torch.cat([_outer(B, B).reshape(-1, 9), _matvec_t(B, r)], 1)
                     for r, _, B in blocks], "pts", 12)
    U = cam_red[:, :36].reshape(C, 6, 6)
    g_c = cam_red[:, 36:]
    V = pt_red[:, :9].reshape(Pn, 3, 3)
    g_p = pt_red[:, 9:]
    W = [_outer(A, B) for _, A, B in blocks]  # [N,6,3], stays on its shard

    # LM damping (additive, Marquardt-style on the diagonal)
    U_d = U + lm_lambda * torch.eye(6, dtype=U.dtype, device=dev)
    V_d = V + lm_lambda * torch.eye(3, dtype=V.dtype, device=dev)
    V_inv = _inv3(V_d)

    # Schur RHS: b = -g_c + W V⁻¹ g_p
    Vg = _matvec(V_inv, g_p)
    b = -g_c + segsum([_matvec(w, v[s.problem.pt_idx]) for w, v, s in zip(W, local(Vg), shards)],
                      "cams", 6)

    def S_apply(x):  # x [C,6] → S x [C,6]
        Ux = _matvec(U_d, x)
        Wx_p = segsum([_matvec_t(w, v[s.problem.cam_idx])
                       for w, v, s in zip(W, local(x), shards)], "pts", 3)
        z = _matvec(V_inv, Wx_p)
        WVz = segsum([_matvec(w, v[s.problem.pt_idx]) for w, v, s in zip(W, local(z), shards)],
                     "cams", 6)
        return Ux - WVz

    M_inv = _inv_spd(U_d)

    def precond(x):
        return _matvec(M_inv, x)

    def back_substitute(dpose):  # Δp = V⁻¹(−g_p − Wᵀ Δc)
        Wt_dc = segsum([_matvec_t(w, v[s.problem.cam_idx])
                        for w, v, s in zip(W, local(dpose), shards)], "pts", 3)
        return _matvec(V_inv, -g_p - Wt_dc)

    return S_apply, precond, b, back_substitute


def _nonzero(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.abs(x) < 1e-12, 1e-12, x)


def _cg(S_apply: Callable, precond: Callable, b: torch.Tensor, iters: int,
        history: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """Preconditioned CG on S x = b from x = 0, ``iters`` steps; appends
    ‖b − S·x_k‖ for k = 0..iters to ``history`` when given."""
    x = torch.zeros_like(b)
    rr = b - S_apply(x)
    z = precond(rr)
    p = z
    rz = (rr * z).sum()
    if history is not None:
        history.append(torch.sqrt((rr * rr).sum()))
    for _ in range(iters):
        Sp = S_apply(p)
        alpha = rz / _nonzero((p * Sp).sum())
        x = x + alpha * p
        rr = rr - alpha * Sp
        z = precond(rr)
        rz_new = (rr * z).sum()
        beta = rz_new / _nonzero(rz)
        p = z + beta * p
        rz = rz_new
        if history is not None:
            history.append(torch.sqrt((rr * rr).sum()))
    return x


def _schur_solve(shards: Sequence[_Shard], blocks, lm_lambda: torch.Tensor, cg_iters: int,
                 dims, owners: Optional[Sequence[int]] = None):
    """One LM step by implicit-Schur CG (block-Jacobi preconditioned):
    ``(dpose [C,6], dpoint [P,3])``."""
    S_apply, precond, b, back_substitute = _schur_system(shards, blocks, lm_lambda, dims,
                                                         owners)
    dpose = _cg(S_apply, precond, b, cg_iters)
    return dpose, back_substitute(dpose)


def _blocks(problem: BAProblem, poses, points, fix_first_cam: bool):
    """Jacobian blocks ``(r, A, B)``, camera 0's A zeroed when it is fixed."""
    r, A, B = _jacobian_blocks(problem, poses, points)
    if fix_first_cam:
        A = A * (problem.cam_idx != 0).to(A.dtype)[:, None, None]
    return r, A, B


def _shard(problem: BAProblem) -> _Shard:
    return _Shard(problem, _segments(problem.cam_idx, problem.poses.shape[0]),
                  _segments(problem.pt_idx, problem.points.shape[0]))


def cg_convergence(problem: BAProblem, cg_iters: int = 30, lm_lambda0: float = 1e-3,
                   use_precond: bool = True, fix_first_cam: bool = True) -> torch.Tensor:
    """Diagnostic: relative CG residual norms ‖b − S·x_k‖ / ‖b‖ for
    k = 0..cg_iters on the first LM step's Schur system; ``use_precond=False``
    runs plain CG for comparison."""
    shard = _shard(problem)
    blocks = _blocks(problem, problem.poses, problem.points, fix_first_cam)
    lm = torch.tensor(lm_lambda0, dtype=torch.float32, device=problem.poses.device)
    dims = (problem.poses.shape[0], problem.points.shape[0], problem.poses.dtype)
    S_apply, precond, b, _ = _schur_system([shard], [blocks], lm, dims)
    if not use_precond:
        precond = lambda x: x  # noqa: E731
    hist: List[torch.Tensor] = []
    _cg(S_apply, precond, b, cg_iters, hist)
    return torch.stack(hist) / torch.clamp(torch.sqrt((b * b).sum()), min=1e-30)


def _rho(s2: torch.Tensor, loss: str, delta: float) -> torch.Tensor:
    """Per-observation robust cost from the squared weighted residual norm
    ``s2``: ``l2`` is ``s2``; ``huber`` quadratic to ``delta`` then linear;
    ``cauchy`` saturates hard outliers."""
    if loss == "l2":
        return s2
    s = torch.sqrt(torch.clamp(s2, min=0.0))
    if loss == "huber":
        return torch.where(s <= delta, s2, 2.0 * delta * s - delta * delta)
    if loss == "cauchy":
        return delta * delta * torch.log1p(s2 / (delta * delta))
    raise ValueError(f"loss must be 'l2', 'huber' or 'cauchy', got {loss!r}")


def _irls_problem(problem: BAProblem, poses, points, loss: str, delta: float) -> BAProblem:
    """The IRLS-reweighted problem for one Gauss–Newton step of the robust
    objective Σ ρ(‖w·rᵢ‖): each weight scaled by √ω, ω = ρ'(s)/(2s)."""
    if loss == "l2":
        return problem
    rw = residuals(problem, poses, points)
    s = torch.sqrt((rw * rw).sum(-1) + 1e-12)
    if loss == "huber":  # a true division (torch computes number / tensor by a reciprocal)
        omega = torch.clamp(s.new_tensor(delta) / s, max=1.0)
    elif loss == "cauchy":
        omega = 1.0 / (1.0 + (s / delta) ** 2)
    else:
        raise ValueError(f"loss must be 'l2', 'huber' or 'cauchy', got {loss!r}")
    return problem._replace(weight=problem.weight * torch.sqrt(omega))


def _cost_sum(problem: BAProblem, poses, points, loss: str, delta: float) -> torch.Tensor:
    r = residuals(problem, poses, points)
    if loss == "l2":
        return (r * r).sum()
    return _rho((r * r).sum(-1), loss, delta).sum()


def _cost(problem: BAProblem, poses, points, loss: str = "l2", delta: float = 4.0):
    wsum = torch.clamp(problem.weight.sum(), min=1.0)
    return _cost_sum(problem, poses, points, loss, delta) / wsum


def _lm(shards: Sequence[_Shard], iters: int, cg_iters: int, lm_lambda0: float,
        fix_first_cam: bool, loss: str, delta: float,
        owners: Optional[Sequence[int]] = None, init=None) -> BAState:
    """The LM loop over ``shards`` (one: the single-device solve; with
    ``owners``, this process's shards of a solve across processes, possibly
    none) from ``init``, the starting poses and points on the device of the
    replicated state (default: the first shard's)."""
    if loss not in LOSSES:
        raise ValueError(f"loss must be 'l2', 'huber' or 'cauchy', got {loss!r}")
    poses, points = (shards[0].problem.poses, shards[0].problem.points) if init is None else init
    dev = poses.device
    dims = (poses.shape[0], points.shape[0], poses.dtype)
    scalar = ((), poses.dtype)
    wsum = torch.clamp(_allsum([s.problem.weight.sum() for s in shards], dev, owners, scalar),
                       min=1.0)

    def cost_of(ps, xs):
        return _allsum([_cost_sum(s.problem, p, x, loss, delta)
                        for s, p, x in zip(shards, local(ps), local(xs))], dev, owners,
                       scalar) / wsum

    def local(x):
        return [x.to(s.problem.uv.device) for s in shards]

    lm = torch.tensor(lm_lambda0, dtype=torch.float32, device=dev)
    cost = cost_of(poses, points)
    for _ in range(iters):
        eff, blocks = [], []
        for s, p, x in zip(shards, local(poses), local(points)):
            eff.append(s._replace(problem=_irls_problem(s.problem, p, x, loss, delta)))
            blocks.append(_blocks(eff[-1].problem, p, x, fix_first_cam))
        dpose, dpoint = _schur_solve(eff, blocks, lm, cg_iters, dims, owners)
        if fix_first_cam:
            dpose = torch.cat([torch.zeros_like(dpose[:1]), dpose[1:]])
        new_poses = poses + dpose
        new_points = points + dpoint
        c_old = cost_of(poses, points)
        c_new = cost_of(new_poses, new_points)
        accept = c_new < c_old
        lm = torch.where(accept, torch.clamp(lm * 0.5, min=1e-7), torch.clamp(lm * 4.0, max=1e3))
        poses = torch.where(accept, new_poses, poses)
        points = torch.where(accept, new_points, points)
        cost = torch.where(accept, c_new, c_old)
    return BAState(poses=poses, points=points, cost=cost, lm_lambda=lm)


def solve(problem: BAProblem, iters: int = 10, cg_iters: int = 10, lm_lambda0: float = 1e-3,
          fix_first_cam: bool = True, loss: str = "l2", loss_delta: float = 4.0) -> BAState:
    """Levenberg–Marquardt on the problem's device. Gauge freedom is fixed
    by freezing camera 0 when ``fix_first_cam``.

    ``loss``: the per-observation cost, ``"l2"`` (default), ``"huber"`` or
    ``"cauchy"`` with scale ``loss_delta`` (pixels of weighted residual).
    The robust modes run IRLS: each LM step reweights observations by
    √(ρ'(s)/2s) of the current residual norm."""
    return _lm([_shard(problem)], iters, cg_iters, lm_lambda0, fix_first_cam, loss, loss_delta)


def _split_observations(problem: BAProblem, devices: Sequence,
                        keep: Optional[Sequence[int]] = None) -> List[BAProblem]:
    """``problem`` with its observations split in order into
    ``len(devices)`` equal shards, shard ``i`` (with copies of the poses,
    points and intrinsics) on ``devices[i]``; only the shards in ``keep``
    (default: all) are made, and the others' observations are never read."""
    n, k = problem.uv.shape[0], len(devices)
    if n % k != 0:
        raise ValueError(f"N={n} observations not divisible by data axis {k}")
    step = n // k
    out = []
    for i in range(k) if keep is None else keep:
        d = devices[i]
        obs = slice(i * step, (i + 1) * step)
        out.append(BAProblem(
            poses=problem.poses.to(d), points=problem.points.to(d),
            intrinsics=problem.intrinsics.to(d), cam_idx=problem.cam_idx[obs].to(d),
            pt_idx=problem.pt_idx[obs].to(d), uv=problem.uv[obs].to(d),
            weight=problem.weight[obs].to(d)))
    return out


def solve_sharded(problem: BAProblem, mesh, iters: int = 10, cg_iters: int = 10,
                  lm_lambda0: float = 1e-3, fix_first_cam: bool = True, loss: str = "l2",
                  loss_delta: float = 4.0) -> BAState:
    """Distributed LM over ``mesh`` (:class:`stepth_tpu_torch.parallel.mesh.Mesh`):
    the observations split in order over its ``data`` shards (shard ``i`` on
    the first device of row ``i``); poses and points are replicated, and
    every reduction is summed on ``mesh.first`` in shard order. The same
    math as :func:`solve`, robust losses included (IRLS weights are
    per-observation and shard-local); the result lies on ``mesh.first``.

    Over a mesh that spans processes every process passes the whole
    problem; it reads only the observations of the shards it owns (none,
    when it owns only slots of the ``tile`` axis, whose replicas of the
    state it then holds), sums the partials of all shards in shard order
    (see the module docstring) and returns the same state as every other
    process, on its own first slot."""
    nd = mesh.shape["data"]
    owners = [mesh.ranks[i][0] for i in range(nd)] if mesh.spans_processes else None
    keep = [i for i in range(nd) if mesh.is_local((i, 0))]
    shards = _split_observations(problem, [row[0] for row in mesh.devices], keep)
    init = problem.poses.to(mesh.first), problem.points.to(mesh.first)
    return _lm([_shard(p) for p in shards], iters, cg_iters, lm_lambda0, fix_first_cam, loss,
               loss_delta, owners, init)

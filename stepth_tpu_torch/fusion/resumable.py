"""Resumable bundle adjustment (twin of ``stepth_tpu/fusion/resumable.py``).

* :func:`solve_resumable` — a segmented LM solve that checkpoints its whole
  iteration state (poses, points, LM λ, the iteration count) every ``every``
  iterations and restores it when its checkpoint already exists. A process
  that dies anywhere resumes by being rerun. Segmenting is exact: the LM
  loop's state across iterations is exactly (poses, points, λ), and every
  reduction of :mod:`stepth_tpu_torch.fusion.ba` is deterministic, so an
  interrupted run continues bit for bit on the same devices.
* :func:`auto_mesh` — a data-parallel mesh over the devices there are now.
  BA state is replicated (observations shard, poses and points are summed
  on the first device), so any subset of devices can continue from the
  checkpoint.

With :func:`stepth_tpu_torch.utils.supervisor.supervise` this closes the
loop: the process dies, the supervisor relaunches it, the checkpoint
restores and the solve continues.
"""

from __future__ import annotations

import hashlib
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from stepth_tpu_torch.fusion import ba
from stepth_tpu_torch.parallel.mesh import Mesh, make_mesh
from stepth_tpu_torch.utils import checkpoint


def auto_mesh(n_obs: int, devices: Optional[Sequence] = None) -> Optional[Mesh]:
    """A mesh of ``data`` shards over ``devices`` (by default every visible
    CUDA device; none visible and no ``devices`` raises), shrunk to the
    largest count that divides ``n_obs`` (:func:`ba.solve_sharded` shards
    observations evenly). ``None`` when only one device is usable: the
    caller runs the single-device solver."""
    if devices is None:
        n_cuda = torch.cuda.device_count()
        if n_cuda == 0:
            raise RuntimeError("auto_mesh: no CUDA device is visible; pass devices= "
                               "(e.g. ['cpu'] * 4) for a mesh on other devices")
        devices = [torch.device("cuda", i) for i in range(n_cuda)]
    devs = list(devices)
    n = len(devs)
    while n > 1 and n_obs % n != 0:
        n -= 1
    if n <= 1:
        return None
    return make_mesh(data=n, tile=1, devices=devs[:n])


def _host(t: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(t.detach().cpu().numpy())


def _problem_fingerprint(problem: ba.BAProblem):
    """Identity of the observation set as ``(shape_fp, content_fp)``, by the
    reference's rule over the same bytes: ``shape_fp`` hashes the pose and
    point shapes and each observation array's shape and dtype,
    ``content_fp`` the bytes of (cam_idx, pt_idx, uv, weight, intrinsics).
    Poses and points are the state being optimised, so they are left out:
    the fingerprint stays fixed across the segments of one solve."""
    obs = [_host(a) for a in (problem.cam_idx, problem.pt_idx, problem.uv, problem.weight,
                              problem.intrinsics)]
    hs = hashlib.sha256()
    hs.update(f"{tuple(problem.poses.shape)}|{tuple(problem.points.shape)}".encode())
    for arr in obs:
        hs.update(f"{arr.shape}|{arr.dtype}".encode())
    hc = hashlib.sha256()
    for arr in obs:
        hc.update(arr.tobytes())
    return hs.hexdigest()[:16], hc.hexdigest()[:16]


def solve_resumable(
    problem: ba.BAProblem,
    ckpt_path: str,
    iters: int = 10,
    cg_iters: int = 10,
    every: int = 5,
    mesh: Optional[Mesh] = None,
    lm_lambda0: float = 1e-3,
    fix_first_cam: bool = True,
    loss: str = "l2",
    loss_delta: float = 4.0,
    on_segment: Optional[Callable[[int, ba.BAState], None]] = None,
) -> ba.BAState:
    """Checkpointed LM solve that survives its process dying at any point.

    Runs ``iters`` LM iterations in segments of ``every``; after each segment
    the whole iteration state is written to ``ckpt_path`` with the number of
    iterations done. If ``ckpt_path`` already holds a checkpoint of this
    problem, the solve resumes from it: rerunning the same call after any
    interruption continues the same trajectory (bit for bit on the same
    devices and mesh; to float tolerance across a mesh change, because the
    order of the per-shard sums changes with the shard count).

    ``mesh=None`` runs :func:`ba.solve`; pass :func:`auto_mesh`'s result to
    shard over the devices there are. ``on_segment(done_iters, state)`` is a
    progress hook; what it raises propagates after the checkpoint is
    written, so a failing hook never loses progress.
    """
    if every <= 0:
        raise ValueError(f"every must be positive, got {every}")
    dev = problem.poses.device
    like = {
        "poses": problem.poses,
        "points": problem.points,
        "lm": torch.zeros((), dtype=torch.float32, device=dev),
        "cost": torch.zeros((), dtype=torch.float32, device=dev),
    }
    shape_fp, content_fp = _problem_fingerprint(problem)
    start, lm = 0, lm_lambda0
    state: Optional[ba.BAState] = None
    meta = checkpoint.metadata(ckpt_path)
    # Resume only a checkpoint written for THIS problem: a stale file of
    # another problem at the same path (with the same iteration count) must
    # not be restored, and one without a fingerprint is rejected (a restart
    # is always correct, resuming the wrong state never is).
    if (meta is not None and meta.get("total_iters") == iters
            and meta.get("fp_shape") == shape_fp
            and meta.get("fp_content") in (None, content_fp)):
        try:
            saved = checkpoint.restore(ckpt_path, like=like)
        except checkpoint.READ_ERRORS:
            saved = None  # truncated or corrupt: restart from scratch
        if saved is not None:
            start = int(meta["iter"])
            lm = float(saved["lm"])
            problem = problem._replace(poses=saved["poses"], points=saved["points"])
            state = ba.BAState(poses=problem.poses, points=problem.points, cost=saved["cost"],
                               lm_lambda=saved["lm"])

    kw = dict(cg_iters=cg_iters, fix_first_cam=fix_first_cam, loss=loss, loss_delta=loss_delta)
    for seg_start in range(start, iters, every):
        n = min(every, iters - seg_start)
        if mesh is None:
            state = ba.solve(problem, iters=n, lm_lambda0=lm, **kw)
        else:
            state = ba.solve_sharded(problem, mesh, iters=n, lm_lambda0=lm, **kw)
        problem = problem._replace(poses=state.poses, points=state.points)
        lm = float(state.lm_lambda)
        done = seg_start + n
        checkpoint.save(
            ckpt_path,
            {"poses": state.poses, "points": state.points, "lm": state.lm_lambda,
             "cost": state.cost},
            metadata={
                "iter": done,
                "total_iters": iters,
                "n_devices": 1 if mesh is None else mesh.shape["data"],
                "fp_shape": shape_fp,
                "fp_content": content_fp,
            },
        )
        if on_segment is not None:
            on_segment(done, state)
    if state is None:
        raise RuntimeError("solve_resumable: no iteration ran and no checkpoint restored "
                           f"(iters={iters})")
    return state

"""Two-process drills of the multi-process layer (twin of the JAX package's
``tools/multiproc_worker.py``).

    python -m stepth_tpu_torch.parallel.drill RANK WORLD PORT MODE[,MODE...]
        [--device cuda|cpu] [--out DIR] [--size small|full] [--check]
        [--paired] [--reps N] [--heartbeat S]

WORLD copies of this worker, ranks 0 … WORLD−1, join one process group
through the ``TCPStore`` their launcher serves at ``localhost:PORT``
(``is_master=False`` in every worker: the launcher binds the port, so no
worker races another for it). Each worker holds ``data · tile / WORLD``
slots of one device (``--device``: ``cuda``, the default, for ``cuda:0``,
which raises when no card is visible: ranks share one card under gloo,
its transfers staged through the host; or ``cpu``, asked for by name),
and the drill's mesh is ``distributed.global_mesh`` over all of them.
Several match-type modes, comma-separated, run one after another in one
process group.

Modes:

* ``match`` — the dense sharded match (``data=1, tile=8``), then
  ``normalize_depth_sharded`` (its max crosses the processes), then the
  other entry points (:func:`entry_points`): ``match_pair_sharded_pallas``
  and ``match_temporal_sharded`` over ``tile=8``, the two batch paths over
  ``data=2, tile=4`` (each rank computes its data row's pairs);
* ``sgm`` — the plain-torch SGM, exact mode, 8 directions: every vertical
  and diagonal carry crosses the process boundary mid-chain;
* ``sgm-pallas`` — the exact mode of ``sgm-pallas``, its relay through K10
  (the plain version on CPU tensors);
* ``hierarchical`` — production census with ``lr_check``
  (``match_hierarchical_sharded``);
* ``ba`` — ``ba.solve_sharded`` with the observations over ``data=8``,
  then over ``data=1, tile=8``, where rank 1 owns no observations and
  holds replicas of the state (``replica_*`` in its result);
* ``resumable`` — ``solve_resumable`` over the global mesh, one checkpoint
  per process (``--out``); rank 1 exits 43 after the segment that ends at
  iteration ``STEPTH_DIE_AT``. Run with WORLD 1, the survivor resumes from
  its checkpoint on ``resumable.auto_mesh`` over 4 slots of its device;
* ``failure`` — rank 1 exits 42 without goodbye; rank 0 must detect it in
  its next barrier and exits 0, printing the seconds from the death;
* ``hung`` — rank 1 sleeps past ``--heartbeat``; rank 0's barrier must
  time out, and it exits 0.

In the match-type modes and ``ba`` every rank overwrites the inputs it
does not own with NaN (255 in the u8 depth map; the observations of other
ranks' shards in ``ba``) before the distributed call. So a result equal to
the same call on a one-process mesh of the same shape (on clean inputs,
required bit for bit) shows that every halo, carry and partial sum
crossed the process boundary. ``--check`` makes that comparison in the
worker (a launcher may make it from the ``.npz`` instead). ``--paired``
also runs the distributed call once with every kernel wrapper checked
against its plain version on the same inputs, call by call. ``--reps N`` times the
distributed call against the one-process call, in turns (median, read on
rank 0; the one-process call runs on rank 0 alone).

Each rank writes its result to ``DIR/<mode>_r<rank>.npz``, prints
``[rank R] <mode> drill OK`` and a line holding one JSON object of its
numbers (launches per frame, bytes sent to the other processes, the
owners of the sharded axis' slots, times); ``comm_model.bytes_sent`` of
the mode's ``FrameDrill.report`` (``ba_report`` for ``ba``) over those
owners gives the bytes each rank sends.
A failed check, or a peer lost anywhere but where the mode expects it,
exits 1; the worker leaves with ``os._exit`` after flushing, since the
process group's threads may block an orderly shutdown once a peer is gone.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import statistics
import sys
import time
import traceback
from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch
import torch.distributed as dist

from stepth_tpu_torch import kernels
from stepth_tpu_torch.config import MatchConfig, PyramidConfig, SGMConfig
from stepth_tpu_torch.fusion import ba, geometry, resumable
from stepth_tpu_torch.match import fused_refine
from stepth_tpu_torch.parallel import (
    comm_model, distributed, sgm_pallas_sharded, sgm_sharded, sharded,
)
from stepth_tpu_torch.parallel.mesh import make_mesh
from stepth_tpu_torch.utils import checkpoint

MATCH_MODES = ("match", "sgm", "sgm-pallas", "hierarchical", "ba")
MODES = MATCH_MODES + ("resumable", "failure", "hung")

# the BA problems: cameras, points, seed, pixel noise, LM and CG iterations,
# a checkpoint every ``every`` (resumable) and the cost the solve must reach
# (small: below 1e-2 of the start; full: the mapping path's 1.5 · 2σ²).
# "full" is the mapping path's BA (chip_smoke.py phase 7a reads it).
BA_SIZES = {"small": dict(cams=4, pts=64, seed=11, sigma=0.0, iters=4, cg=8, every=2),
            "full": dict(cams=8, pts=4096, seed=11, sigma=0.3, iters=10, cg=10, every=5)}
RESUMABLE_ITERS = {"small": 6, "full": 10}


def ba_problem(cams: int, pts: int, seed: int, sigma: float, device="cpu") -> ba.BAProblem:
    """A deterministic BA problem, the same on every process: ``cams``
    cameras on an arc observing ``pts`` points (the reference drill's
    ``_ba_problem_np`` at 4 × 64, its draws in its order), the
    observations exact, or with Gaussian pixel noise ``sigma`` drawn after
    the reference's draws."""
    rng = np.random.default_rng(seed)
    intr = np.array([400.0, 400.0, 320.0, 240.0], np.float32)
    pts_gt = rng.uniform(-1.0, 1.0, (pts, 3)).astype(np.float32)
    pts_gt[:, 2] += 6.0
    poses_gt = np.stack([np.concatenate([
        np.array([0.0, 0.08 * (c - cams / 2), 0.0], np.float32),
        np.array([0.4 * c, 0.0, 0.0], np.float32)]) for c in range(cams)]).astype(np.float32)
    cam_idx = np.repeat(np.arange(cams), pts).astype(np.int32)
    pt_idx = np.tile(np.arange(pts), cams).astype(np.int32)
    uv = geometry.project(geometry.transform(torch.from_numpy(poses_gt)[cam_idx],
                                             torch.from_numpy(pts_gt)[pt_idx]),
                          torch.from_numpy(intr)).numpy()
    poses0 = poses_gt + rng.normal(0, 0.03, poses_gt.shape).astype(np.float32)
    poses0[0] = poses_gt[0]  # gauge anchor stays exact
    pts0 = (pts_gt + rng.normal(0, 0.12, pts_gt.shape)).astype(np.float32)
    if sigma:
        uv = (uv + rng.normal(0, sigma, uv.shape)).astype(np.float32)
    weight = np.ones(len(cam_idx), np.float32)
    return ba.problem_from_arrays(dict(poses=poses0, points=pts0, intrinsics=intr,
                                       cam_idx=cam_idx, pt_idx=pt_idx, uv=uv, weight=weight),
                                  device)


def make_pair(h: int, w: int, shift: int = 24, seed: int = 0):
    """The benchmark's smooth textured pair (right = left shifted by
    ``shift`` px): box-blurred uniform noise."""
    left, rights = make_clip(h, w, [shift], seed)
    return left, rights[0]


def make_clip(h: int, w: int, shifts, seed: int = 0):
    """One left view and a right view per shift of the same texture."""
    rng = np.random.default_rng(seed)
    tex = rng.uniform(0, 255, size=(h, w + max(shifts))).astype(np.float32)
    k = np.ones(9, np.float32) / 9
    tex = np.apply_along_axis(lambda m: np.convolve(m, k, mode="same"), 1, tex)
    tex = np.apply_along_axis(lambda m: np.convolve(m, k, mode="same"), 0, tex)
    return (np.ascontiguousarray(tex[:, :w]),
            [np.ascontiguousarray(tex[:, s:s + w]) for s in shifts])


def random_pair(h: int, w: int, shift: int, seed: int, integer: bool = False):
    """The reference drill's pair: uniform noise, right = left rolled by
    ``shift`` columns (rounded to integers with ``integer``)."""
    left = np.random.default_rng(seed).uniform(0, 255, (h, w)).astype(np.float32)
    if integer:
        left = np.round(left)
    return left, np.roll(left, -shift, axis=1).astype(np.float32)


class FrameDrill(NamedTuple):
    """A match-type mode: the mesh shape, the inputs, ``call(left, right,
    mesh, stages)`` returning a ``MatchResult`` (``stages``: the matcher's
    stage table, which the paths without kernels ignore), and the
    communication model of the call over the mesh's ``tile`` axis."""

    shape: Tuple[int, int]
    pair: Tuple[np.ndarray, np.ndarray]
    call: Callable
    report: comm_model.CommReport


def frame_drill(mode: str, size: str) -> FrameDrill:
    """The :class:`FrameDrill` of a match-type mode at ``size``."""
    if mode == "match":
        cfg, pair = MatchConfig(num_disparities=16, window=9, cost="sad"), random_pair(64, 96, 5, 7)
        return FrameDrill((1, 8), pair,
                          lambda l, r, m, _: sharded.match_pair_sharded(l, r, cfg, m),
                          comm_model.comm_dense_sharded(cfg, *pair[0].shape, 8))
    if mode == "sgm":
        cfg = MatchConfig(num_disparities=16, window=5, lr_threshold=1.0)
        sc, pair = SGMConfig(directions=8), random_pair(64, 96, 5, 13)
        return FrameDrill((1, 8), pair, lambda l, r, m, _: (
            sgm_sharded.match_pair_sgm_sharded(l, r, cfg, sc, m)),
            comm_model.comm_sgm_sharded(cfg, *pair[0].shape, 8, sc.directions))
    if mode == "sgm-pallas":
        if size == "small":
            cfg, sc, shape, pair = (MatchConfig(num_disparities=16, window=5, lr_threshold=1.0),
                                    SGMConfig(directions=8), (1, 8), random_pair(64, 96, 5, 13))
        else:  # chip_smoke's path 3 (1088 rows: a 272-row shard, a multiple of 8)
            cfg, sc, shape, pair = (MatchConfig(num_disparities=64, window=5, cost="sad",
                                                lr_threshold=1.0),
                                    SGMConfig(directions=4), (1, 4), make_pair(1088, 1920))
        return FrameDrill(shape, pair, lambda l, r, m, s: (
            sgm_pallas_sharded.match_pair_sgm_pallas_sharded(l, r, cfg, sc, m, exact=True,
                                                             stages=s)),
            comm_model.comm_sgm_sharded(cfg, *pair[0].shape, shape[1], sc.directions,
                                        pallas=True))
    if mode == "hierarchical":
        if size == "small":
            cfg = MatchConfig(num_disparities=16, window=9, cost="census", census_window=5)
            pyr, tile_rows, shape = PyramidConfig(levels=2, coarsest_disparities=8), 8, (1, 8)
            pair = random_pair(128, 96, 5, 3, integer=True)
        else:  # production at 1024 rows: 1080 admits no 4-shard mesh at levels=4
            cfg = MatchConfig(num_disparities=128, window=9, cost="census")
            pyr, tile_rows, shape = PyramidConfig(levels=4, coarsest_disparities=16), 32, (1, 4)
            pair = make_pair(1024, 1920)
        return FrameDrill(shape, pair, lambda l, r, m, s: sharded.match_hierarchical_sharded(
            l, r, cfg, pyr, m, tile_rows=tile_rows, lr_check=True, stages=s),
            comm_model.comm_hierarchical_sharded(cfg, pyr, *pair[0].shape, shape[1], tile_rows))
    raise ValueError(f"not a match-type mode: {mode}")


def ba_report(size: str) -> comm_model.CommReport:
    """The communication model of the ``ba`` drill's solve on ``data=8``."""
    s = BA_SIZES[size]
    return comm_model.comm_ba_sharded(s["cams"], s["pts"], s["iters"], s["cg"], n=8)


def entry_points():
    """The other sharded entry points of the ``match`` mode, small: ``(name,
    mesh shape, lefts, rights, call)``, where the inputs carry a leading
    frame axis for the temporal and batch paths and ``call(lefts, rights,
    mesh)`` returns a ``MatchResult`` or a disparity tensor."""
    sad = MatchConfig(num_disparities=16, window=9, cost="sad")
    census = MatchConfig(num_disparities=16, window=9, cost="census", census_window=5)
    pyr = PyramidConfig(levels=2, coarsest_disparities=8)
    l7, r7 = random_pair(64, 96, 5, 7)
    l13, r13 = random_pair(64, 96, 5, 13)
    l3, r3 = random_pair(128, 96, 5, 3, integer=True)
    _, r3b = random_pair(128, 96, 6, 3, integer=True)
    clip = np.stack([l3, l3]), np.stack([r3, r3b])
    return [
        ("pallas", (1, 8), l7, r7,
         lambda l, r, m: sharded.match_pair_sharded_pallas(l, r, sad, m, tile_rows=8)),
        ("temporal", (1, 8), *clip,
         lambda l, r, m: sharded.match_temporal_sharded(l, r, census, pyr, m, tile_rows=8,
                                                        lr_check=True)),
        ("batch", (2, 4), np.stack([l7, l13]), np.stack([r7, r13]),
         lambda l, r, m: sharded.match_batch_sharded(l, r, sad, m)),
        ("batch_hierarchical", (2, 4), *clip,
         lambda l, r, m: sharded.match_batch_hierarchical_sharded(l, r, census, pyr, m,
                                                                  tile_rows=8, lr_check=True)),
    ]


# ---- checks ---------------------------------------------------------------


def bits_equal(want: torch.Tensor, got: torch.Tensor) -> bool:
    """Equal shapes and values, NaN at the same places."""
    if want.shape != got.shape or want.dtype != got.dtype:
        return False
    if want.is_floating_point():
        nan = torch.isnan(want)
        return torch.equal(nan, torch.isnan(got)) and torch.equal(want[~nan], got[~nan])
    return torch.equal(want, got)


def paired(tag: str, names, fused, plain, seen: dict, err=None):
    """A pipeline stage that runs a kernel's wrapper and its plain version
    on the same inputs (the plain one on copies, as a wrapper may update
    an accumulator in place), raises unless every output is equal (NaN at
    the same places, every other value in the same bits; masks equal;
    non-tensor outputs equal), records each kernel's calls and shapes in
    ``seen`` (``name: (calls, shapes)``) and ``err(name, 0.0)`` per output,
    and passes the wrapper's outputs on."""
    def clone(a):
        return a.clone() if isinstance(a, torch.Tensor) else a

    def run(*args, **kw):
        want = plain(*map(clone, args), **{k: clone(v) for k, v in kw.items()})
        got = fused(*args, **kw)
        single = not isinstance(want, tuple)
        ws, gs = ((want,), (got,)) if single else (want, got)
        names_out = [names[min(i, len(names) - 1)] for i in range(len(ws))]
        for name, w, g in zip(names_out, ws, gs):
            if w is None:
                continue
            if not (bits_equal(w.to(g.device), g) if isinstance(w, torch.Tensor) else w == g):
                raise AssertionError(f"{tag}: {name} at {tuple(ws[0].shape)} differs from its "
                                     "plain version")
            if err is not None:
                err(name, 0.0)
        for name in dict.fromkeys(n for n, w in zip(names_out, ws) if w is not None):
            calls, shapes = seen.get(name, (0, set()))
            seen[name] = (calls + 1, shapes | {tuple(ws[0].shape)})
        return got
    return run


def checked_stages(tag: str, seen: dict, err=None) -> fused_refine.Stages:
    """The matcher's stage table with every stage :func:`paired`: the
    field of ``fused_refine.FUSED`` against the same field of ``PLAIN``,
    its outputs named by ``fused_refine.STAGE_KERNELS``."""
    return fused_refine.Stages(**{
        field: paired(tag, fused_refine.STAGE_KERNELS[field], getattr(fused_refine.FUSED, field),
                      getattr(fused_refine.PLAIN, field), seen, err)
        for field in fused_refine.Stages._fields})


# ---- the worker -----------------------------------------------------------


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _driven(fn, dev):
    """``fn()`` with every launch count and the traffic counter set to 0
    just before; returns its output, the launches and the bytes sent."""
    registry = kernels.registry()
    for k in registry.values():
        k.launches = 0
    distributed.traffic.reset()
    out = fn()
    _sync(dev)
    return out, {n: k.launches for n, k in registry.items()}, distributed.traffic.bytes_sent


def _turns(two, one, reps: int, dev) -> dict:
    """Median ms of ``two()`` (every process, bracketed by barriers) and of
    ``one()`` (rank 0 alone, the others waiting), timed in turns."""
    t2, t1 = [], []
    rank = distributed.process_info()[0]
    for _ in range(reps):
        distributed.barrier()
        t0 = time.perf_counter()
        two()
        _sync(dev)
        distributed.barrier()
        t2.append((time.perf_counter() - t0) * 1e3)
        if rank == 0:
            t0 = time.perf_counter()
            one()
            _sync(dev)
            t1.append((time.perf_counter() - t0) * 1e3)
        distributed.barrier()
    return {"ms_2p": statistics.median(t2), "ms_1p": statistics.median(t1) if t1 else None,
            "ms_2p_runs": t2, "ms_1p_runs": t1}


def _poison_rows(x: np.ndarray, mesh, value, row: int = 0) -> np.ndarray:
    """``x`` ``[..., H, W]`` with the image rows of every slot of mesh row
    ``row`` that this process does not own set to ``value``."""
    r = mesh.row(row)
    th = x.shape[-2] // len(r.devices)
    x = x.copy()
    for i in range(len(r.devices)):
        if not r.is_local(i):
            x[..., i * th:(i + 1) * th, :] = value
    return x


def _poison_inputs(x: np.ndarray, mesh, frames: bool) -> np.ndarray:
    """The poisoned inputs of an entry point: per frame by its data row's
    slots for a batch (``frames``), else by mesh row 0's."""
    if not frames:
        return _poison_rows(x, mesh, np.nan)
    per_row = x.shape[0] // mesh.shape["data"]
    return np.stack([_poison_rows(f, mesh, np.nan, k // per_row) for k, f in enumerate(x)])


def _fields(res):
    return res._asdict() if hasattr(res, "_asdict") else {"disparity": res}


def _check_one_process(tag: str, got, want_fn, check: bool) -> None:
    """With ``check``, ``got`` against ``want_fn()``, the same call on a
    one-process mesh of the same shape, bit for bit in every field."""
    if not check:
        return
    want = _fields(want_fn())
    for field, g in _fields(got).items():
        if not bits_equal(want[field].to(g.device), g):
            raise AssertionError(f"{tag}: {field} differs from the one-process mesh")


def _slots(shape, dev, world: int):
    data, tile = shape
    if (data * tile) % world:
        raise ValueError(f"a {data}x{tile} mesh does not split over {world} processes")
    return [dev] * (data * tile // world)


def _report(mode: str, rank: int, numbers: dict) -> None:
    print(f"[rank {rank}] {mode} drill OK", flush=True)
    print(json.dumps({"drill": mode, "rank": rank, **numbers}), flush=True)


def _match_mode(mode: str, args, dev, rank: int, world: int) -> None:
    shape, (left, right), call, _ = frame_drill(mode, args.size)
    mesh = distributed.global_mesh(*shape, devices=_slots(shape, dev, world))
    one = make_mesh(*shape, devices=[dev] * (shape[0] * shape[1]))
    pl, pr = (torch.from_numpy(_poison_rows(x, mesh, np.nan)).to(dev) for x in (left, right))
    cl, cr = (torch.from_numpy(x).to(dev) for x in (left, right))
    fused = fused_refine.FUSED
    res, launches, nbytes = _driven(lambda: call(pl, pr, mesh, fused), dev)
    _check_one_process(mode, res, lambda: call(cl, cr, one, fused), args.check)
    numbers = {"shape": list(left.shape), "mesh": list(shape),
               "slots_per_rank": shape[0] * shape[1] // world, "owners": list(mesh.ranks[0]),
               "launches": launches, "bytes_per_frame": nbytes,
               "valid_share": float(res.valid.float().mean())}
    if args.size == "full":
        med = float(res.disparity[50:-50, 100:-100].median())
        numbers["median_disparity"] = med
        if not abs(med - 24.0) <= 0.5:
            raise AssertionError(f"{mode}: median disparity {med} != 24 +- 0.5")
    if args.paired:
        seen = {}
        again = call(pl, pr, mesh, checked_stages(mode, seen))
        for name, w, g in zip(res._fields, res, again):
            if not bits_equal(w, g):
                raise AssertionError(f"{mode}: the checked run's {name} differs")
        numbers["paired"] = {k: [n, sorted(s)] for k, (n, s) in seen.items()}
    out = {k: v.cpu().numpy() for k, v in res._asdict().items()}
    if mode == "match":
        raw = (np.abs(out["disparity"]) * 20).astype(np.uint8)
        norm = sharded.normalize_depth_sharded(
            torch.from_numpy(_poison_rows(raw, mesh, 255)).to(dev), mesh).cpu().numpy()
        want_norm = (raw.astype(np.int64) * 255 // int(raw.max())).astype(np.uint8)
        if not np.array_equal(norm, want_norm):
            raise AssertionError("match: normalize_depth_sharded is not the global max rule")
        out["normalized"] = norm
        for name, shape, lefts, rights, ep in entry_points():
            m = distributed.global_mesh(*shape, devices=_slots(shape, dev, world))
            batch = name.startswith("batch")
            got = ep(*(torch.from_numpy(_poison_inputs(x, m, batch)).to(dev)
                       for x in (lefts, rights)), m)
            _check_one_process(name, got, lambda: ep(
                *(torch.from_numpy(x).to(dev) for x in (lefts, rights)),
                make_mesh(*shape, devices=[dev] * (shape[0] * shape[1]))), args.check)
            out[f"{name}_disparity"] = _fields(got)["disparity"].cpu().numpy()
    if args.reps:
        numbers.update(_turns(lambda: call(pl, pr, mesh, fused),
                              lambda: call(cl, cr, one, fused), args.reps, dev))
    _save(args, mode, rank, out)
    _report(mode, rank, numbers)


def _poison_obs(problem: ba.BAProblem, mesh) -> ba.BAProblem:
    """``problem`` with the observations of every data shard this process
    does not own set to NaN."""
    step = problem.uv.shape[0] // mesh.shape["data"]
    uv, weight = problem.uv.clone(), problem.weight.clone()
    for i in range(mesh.shape["data"]):
        if not mesh.is_local((i, 0)):
            uv[i * step:(i + 1) * step] = float("nan")
            weight[i * step:(i + 1) * step] = float("nan")
    return problem._replace(uv=uv, weight=weight)


def _ba_mode(args, dev, rank: int, world: int) -> None:
    size = BA_SIZES[args.size]
    problem = ba_problem(size["cams"], size["pts"], size["seed"], size["sigma"], dev)
    mesh = distributed.global_mesh(8, 1, devices=_slots((8, 1), dev, world))
    one = make_mesh(8, 1, devices=[dev] * 8)
    poisoned = _poison_obs(problem, mesh)
    kw = dict(iters=size["iters"], cg_iters=size["cg"])
    st, _, nbytes = _driven(lambda: ba.solve_sharded(poisoned, mesh, **kw), dev)
    _check_one_process("ba", st, lambda: ba.solve_sharded(problem, one, **kw), args.check)
    # tile replicas: one data shard, owned by rank 0; the other ranks hold
    # replicas and read no observation
    replicas = distributed.global_mesh(1, 8, devices=_slots((1, 8), dev, world))
    replica = ba.solve_sharded(_poison_obs(problem, replicas), replicas, **kw)
    _check_one_process("ba replicas", replica, lambda: ba.solve_sharded(
        problem, make_mesh(1, 8, devices=[dev] * 8), **kw), args.check)
    c0 = float(ba._cost(problem, problem.poses, problem.points))
    c = float(st.cost)
    limit = 1.5 * 2 * size["sigma"] ** 2 if size["sigma"] else 1e-2 * c0
    if not c < limit:
        raise AssertionError(f"ba: cost {c} not below {limit} (from {c0})")
    numbers = {"cams": size["cams"], "points": size["pts"], "lm_iters": size["iters"],
               "cg_iters": size["cg"], "cost0": c0, "cost": c,
               "owners": [mesh.ranks[i][0] for i in range(8)], "bytes_per_solve": nbytes}
    if args.reps:
        t = _turns(lambda: ba.solve_sharded(poisoned, mesh, **kw),
                   lambda: ba.solve_sharded(problem, one, **kw), args.reps, dev)
        numbers.update(t, lm_iters_per_s_2p=size["iters"] / t["ms_2p"] * 1e3,
                       lm_iters_per_s_1p=(size["iters"] / t["ms_1p"] * 1e3
                                          if t["ms_1p"] else None))
    _save(args, "ba", rank, {**{k: v.cpu().numpy() for k, v in st._asdict().items()},
                             **{f"replica_{k}": v.cpu().numpy()
                                for k, v in replica._asdict().items()}})
    _report("ba", rank, numbers)


def _resumable_mode(args, dev, rank: int, world: int) -> None:
    """Phase 1 (WORLD 2): both ranks solve over the global mesh, one
    checkpoint each; rank 1 dies at ``STEPTH_DIE_AT`` and rank 0's next
    collective fails. Phase 2 (WORLD 1, relaunched by a supervisor): the
    survivor resumes from its checkpoint on the devices it has."""
    size = BA_SIZES[args.size]
    problem = ba_problem(size["cams"], size["pts"], size["seed"], size["sigma"], dev)
    die_at = int(os.environ.get("STEPTH_DIE_AT", "-1"))
    ckpt = os.path.join(args.out, f"ba_resumable_p{rank}.npz")
    if world > 1:
        mesh = distributed.global_mesh(8, 1, devices=_slots((8, 1), dev, world))
    else:
        mesh = resumable.auto_mesh(problem.uv.shape[0], devices=[dev] * 4)
    meta = checkpoint.metadata(ckpt)
    if meta is not None:
        print(f"[rank {rank}] resuming from iteration {meta['iter']} on a "
              f"{mesh.shape['data']}-shard mesh", flush=True)

    def on_segment(done, state):
        print(f"[rank {rank}] segment done: iteration {done}, cost {float(state.cost):.6e}",
              flush=True)
        if rank == 1 and done == die_at:
            os._exit(43)  # no goodbye: the peer must detect it

    t0 = time.perf_counter()
    st = resumable.solve_resumable(problem, ckpt, iters=RESUMABLE_ITERS[args.size],
                                   cg_iters=size["cg"], every=size["every"], mesh=mesh,
                                   on_segment=on_segment)
    seconds = time.perf_counter() - t0
    c0 = float(ba._cost(problem, problem.poses, problem.points))
    c = float(st.cost)
    limit = 1.5 * 2 * size["sigma"] ** 2 if size["sigma"] else 1e-2 * c0
    if not c < limit:
        raise AssertionError(f"resumable: cost {c} not below {limit} (from {c0})")
    np.savez(os.path.join(args.out, f"final_p{rank}.npz"), poses=st.poses.cpu().numpy(),
             points=st.points.cpu().numpy(), cost=c)
    _report("resumable", rank, {"cost0": c0, "cost": c, "limit": limit,
                                "resumed_from": None if meta is None else meta["iter"],
                                "mesh_data": mesh.shape["data"], "seconds": seconds})


def _failure_mode(args, rank: int, hung: bool) -> None:
    """Rank 1 dies (``failure``) or sleeps past the heartbeat (``hung``)
    after a first barrier; rank 0's next barrier must raise, and rank 0
    exits 0 with the seconds to detection."""
    distributed.barrier()
    if rank == 1:
        if hung:
            time.sleep(args.heartbeat + 2)
            os._exit(44)
        if args.out:
            with open(os.path.join(args.out, "died_r1.json"), "w") as f:
                json.dump({"t": time.time()}, f)
        os._exit(42)
    t0 = time.time()
    try:
        distributed.barrier()
    except RuntimeError as e:
        t1 = time.time()
        since = None
        if not hung and args.out and os.path.exists(os.path.join(args.out, "died_r1.json")):
            with open(os.path.join(args.out, "died_r1.json")) as f:
                since = t1 - json.load(f)["t"]
        what = "hang" if hung else "failure"
        print(f"[rank 0] peer {what} detected in {t1 - t0:.3f} s after the barrier began"
              + ("" if since is None else f", {since:.3f} s after the peer died")
              + f": {type(e).__name__}", flush=True)
        print(json.dumps({"drill": "hung" if hung else "failure", "rank": 0,
                          "detect_s": t1 - t0, "since_death_s": since}), flush=True)
        os._exit(0)
    raise AssertionError("barrier succeeded after the peer was lost: the detector is inert")


def _save(args, mode: str, rank: int, arrays: dict) -> None:
    if args.out:
        np.savez(os.path.join(args.out, f"{mode}_r{rank}.npz"), **arrays)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m stepth_tpu_torch.parallel.drill",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("rank", type=int)
    ap.add_argument("world", type=int)
    ap.add_argument("port", type=int, help="the launcher's TCPStore port on localhost")
    ap.add_argument("mode", help=f"one or more of {', '.join(MODES)}, comma-separated")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda:0 (raises when no card is visible), or the CPU by name")
    ap.add_argument("--out", default=None, help="directory for results and checkpoints")
    ap.add_argument("--size", choices=("small", "full"), default="small")
    ap.add_argument("--check", action="store_true",
                    help="hold each result to the one-process mesh here, bit for bit")
    ap.add_argument("--paired", action="store_true",
                    help="check every kernel call against its plain version")
    ap.add_argument("--reps", type=int, default=0, help="timed runs, in turns")
    ap.add_argument("--heartbeat", type=int, default=60,
                    help="seconds a transfer waits on a peer before it raises")
    args = ap.parse_args(argv)
    modes = args.mode.split(",")
    if any(m not in MODES for m in modes):
        ap.error(f"unknown mode in {args.mode!r}")
    if len(modes) > 1 and any(m not in MATCH_MODES for m in modes):
        ap.error("only the match-type modes and ba run in one process group")
    return args, modes


def run(args, modes) -> None:
    dev = torch.device("cuda", 0) if args.device == "cuda" else torch.device("cpu")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("drill: no CUDA device is visible; pass --device cpu for a drill "
                           "on the CPU")
    torch.set_num_threads(1)  # workers share the machine's cores
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if args.world > 1:
        store = dist.TCPStore("localhost", args.port, args.world, is_master=False,
                              timeout=datetime.timedelta(seconds=120))
        distributed.initialize(num_processes=args.world, process_id=args.rank,
                               heartbeat_timeout_s=args.heartbeat,
                               initialization_timeout_s=120, backend="gloo", store=store)
    if distributed.process_info() != (args.rank, args.world):
        raise AssertionError(f"process_info {distributed.process_info()} != "
                             f"{(args.rank, args.world)}")
    for mode in modes:
        if mode == "ba":
            _ba_mode(args, dev, args.rank, args.world)
        elif mode == "resumable":
            _resumable_mode(args, dev, args.rank, args.world)
        elif mode in ("failure", "hung"):
            _failure_mode(args, args.rank, hung=mode == "hung")
        else:
            _match_mode(mode, args, dev, args.rank, args.world)
    if args.world > 1:
        distributed.barrier()
        dist.destroy_process_group()


def main(argv=None) -> None:
    args, modes = parse_args(argv)
    try:
        run(args, modes)
    except Exception:  # noqa: BLE001 — the worker's boundary: report, then leave at once
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)


if __name__ == "__main__":
    main()

"""Two-process drills of the port's multi-process layer (twin of
``tests/test_multiprocess.py``): a drill serves a ``TCPStore`` on a port
the OS picks, spawns ``python -m stepth_tpu_torch.parallel.drill`` twice
(4 CPU slots each, gloo), and the tests hold the workers' results. The
match-type drills and BA run one after another in one worker pair (a
module fixture), as ``chip_smoke.py`` phase 8 runs them: a worker's
start-up costs more CPU than its drills at these sizes.

Every worker poisons the input rows it does not own with NaN, so a result
equal to the one-process mesh of the same shape shows the halos, carries,
gathers and partial sums crossed the process boundary. Checks:

* each rank's ``.npz`` equals the port's one-process mesh of the same shape
  bit for bit (match, with the other entry points of ``drill.entry_points``;
  sgm, sgm-pallas, hierarchical, ba);
* the JAX package in-process, as its own drill holds it: dense and SGM
  disparity within 1e-5 with equal valid masks, the normalised map equal,
  BA poses and points within 5e-3 of ``ba.solve`` and the cost converged;
* failure and hung peers detected within the heartbeat + 10 s, and the
  supervised resume on the survivor's shrunken mesh.

Sizes are the reference drill's (64×96, D=16; BA 4 cameras × 64 points);
the hierarchical drill takes 128 rows, the least that gives each of 8
shards a coarse level at ``levels=2``.
"""

import datetime
import json
import os
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from stepth_tpu.config import MatchConfig as RefMatchConfig
from stepth_tpu.fusion import ba as ref_ba
from stepth_tpu.fusion import geometry as ref_geo
from stepth_tpu.match import dense as ref_dense
from stepth_tpu.match import sgm as ref_sgm
from stepth_tpu_torch.fusion import ba
from stepth_tpu_torch.match import fused_refine
from stepth_tpu_torch.parallel import comm_model, drill
from stepth_tpu_torch.parallel.mesh import make_mesh
from stepth_tpu_torch.utils import supervisor

from tests.torch_port import np_, one_torch_thread  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120  # per drill; a deadlock fails the test instead of hanging it
HEARTBEAT_S = 4


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.update(extra)
    return env


def _argv(rank, world, port, mode, out, *extra):
    return [sys.executable, "-m", "stepth_tpu_torch.parallel.drill", str(rank), str(world),
            str(port), mode, "--device", "cpu", "--out", str(out), *extra]


def _run_drill(mode, out, expect_codes=(0, 0), extra=(), env=None):
    """Both workers of a drill against a store served here; returns their
    outputs after checking their exit codes."""
    store = dist.TCPStore("localhost", 0, None, is_master=True, wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=TIMEOUT_S))
    procs = [subprocess.Popen(_argv(r, 2, store.port, mode, out, *extra), env=env or _env(),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    deadline = time.monotonic() + TIMEOUT_S
    outs = {}
    try:
        for r, p in enumerate(procs):
            outs[r] = p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == expect_codes[r], (
            f"rank {r} rc={p.returncode}\n--- rank 0 ---\n{outs.get(0)}\n--- rank 1 ---\n"
            f"{outs.get(1)}")
    return outs


MATCH_DRILLS = ("match", "sgm", "sgm-pallas", "hierarchical", "ba")


@pytest.fixture(scope="module")
def match_drills(tmp_path_factory):
    """The outputs and result directory of the match-type drills and BA,
    run in one worker pair."""
    out = tmp_path_factory.mktemp("drills")
    return _run_drill(",".join(MATCH_DRILLS), out), out


def _numbers(out, mode):
    lines = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    return next(x for x in lines if x["drill"] == mode)


def _one_process(mode):
    """The drill's call on a one-process mesh of its shape, its inputs and
    the inputs themselves."""
    shape, (left, right), call, _ = drill.frame_drill(mode, "small")
    one = make_mesh(*shape, devices=["cpu"] * (shape[0] * shape[1]))
    return (call(torch.from_numpy(left), torch.from_numpy(right), one, fused_refine.FUSED),
            left, right)


def _check_bytes(outs, mode, key="bytes_per_frame"):
    """Each rank's bytes sent, as the port's communication model gives them
    for the drill's slot owners."""
    report = drill.ba_report("small") if mode == "ba" else drill.frame_drill(mode, "small").report
    for r in range(2):
        numbers = _numbers(outs[r], mode)
        assert numbers["owners"] == [0] * 4 + [1] * 4
        assert numbers[key] == comm_model.bytes_sent(report, numbers["owners"], r), report.table()


def _check_ranks_bit_equal(mode, out, want):
    for r in range(2):
        got = np.load(out / f"{mode}_r{r}.npz")
        for name in want._fields:
            np.testing.assert_array_equal(got[name], np_(getattr(want, name)),
                                          err_msg=f"{mode} rank {r} {name}")


@pytest.mark.parametrize("mode", ["match", "sgm"])
def test_two_process_match_and_sgm(match_drills, mode):
    outs, tmp_path = match_drills
    for r in range(2):
        assert f"[rank {r}] {mode} drill OK" in outs[r]
    _check_bytes(outs, mode)
    want, left, right = _one_process(mode)
    _check_ranks_bit_equal(mode, tmp_path, want)
    if mode == "match":
        ref = ref_dense.match_pair(left, right, RefMatchConfig(num_disparities=16, window=9,
                                                               cost="sad"))
    else:
        ref = ref_sgm.match_pair_sgm(left, right, RefMatchConfig(num_disparities=16, window=5,
                                                                 lr_threshold=1.0),
                                     ref_sgm.SGMConfig(directions=8))
    for r in range(2):
        got = np.load(tmp_path / f"{mode}_r{r}.npz")
        np.testing.assert_allclose(got["disparity"], np.asarray(ref.disparity), atol=1e-5)
        np.testing.assert_array_equal(got["valid"], np.asarray(ref.valid))
        if mode == "match":
            raw = (np.abs(np.asarray(ref.disparity)) * 20).astype(np.uint8)
            want_norm = (raw.astype(np.int64) * 255 // int(raw.max())).astype(np.uint8)
            np.testing.assert_array_equal(got["normalized"], want_norm)
    if mode == "match":  # the other entry points, run in the same drill
        for name, shape, lefts, rights, call in drill.entry_points():
            res = call(torch.from_numpy(lefts), torch.from_numpy(rights),
                       make_mesh(*shape, devices=["cpu"] * (shape[0] * shape[1])))
            want_d = np_(res.disparity if hasattr(res, "disparity") else res)
            for r in range(2):
                np.testing.assert_array_equal(
                    np.load(tmp_path / f"match_r{r}.npz")[f"{name}_disparity"], want_d,
                    err_msg=f"{name} rank {r}")


@pytest.mark.parametrize("mode", ["sgm-pallas", "hierarchical"])
def test_two_process_kernel_paths(match_drills, mode):
    """The K10 relay (its plain version on the CPU) and the production
    pyramid with ``lr_check`` across the processes, equal to the
    one-process mesh bit for bit."""
    outs, tmp_path = match_drills
    for r in range(2):
        assert f"[rank {r}] {mode} drill OK" in outs[r]
    _check_bytes(outs, mode)
    want, _, _ = _one_process(mode)
    assert 0.9 < float(want.valid.float().mean()) < 1.0
    _check_ranks_bit_equal(mode, tmp_path, want)


def _ba_problem_np():
    """The JAX package's drill problem (``tools/multiproc_worker.py``):
    4 cameras on an arc observing 64 points, N=256 observations."""
    rng = np.random.default_rng(11)
    n_cams, n_pts = 4, 64
    intr = np.array([400.0, 400.0, 320.0, 240.0], np.float32)
    pts_gt = rng.uniform(-1.0, 1.0, (n_pts, 3)).astype(np.float32)
    pts_gt[:, 2] += 6.0
    poses_gt = np.stack([np.concatenate([
        np.array([0.0, 0.08 * (c - n_cams / 2), 0.0], np.float32),
        np.array([0.4 * c, 0.0, 0.0], np.float32)]) for c in range(n_cams)]).astype(np.float32)
    cam_idx = np.repeat(np.arange(n_cams), n_pts).astype(np.int32)
    pt_idx = np.tile(np.arange(n_pts), n_cams).astype(np.int32)
    uv = np.asarray(ref_geo.project(ref_geo.transform(jnp.asarray(poses_gt)[cam_idx],
                                                      jnp.asarray(pts_gt)[pt_idx]),
                                    jnp.asarray(intr)))
    poses0 = poses_gt + rng.normal(0, 0.03, poses_gt.shape).astype(np.float32)
    poses0[0] = poses_gt[0]
    pts0 = (pts_gt + rng.normal(0, 0.12, pts_gt.shape)).astype(np.float32)
    weight = np.ones(len(cam_idx), np.float32)
    return dict(poses=poses0, points=pts0, intrinsics=intr, cam_idx=cam_idx, pt_idx=pt_idx,
                uv=uv, weight=weight)


def test_two_process_distributed_ba(match_drills):
    outs, tmp_path = match_drills
    for r in range(2):
        assert f"[rank {r}] ba drill OK" in outs[r]
    _check_bytes(outs, "ba", "bytes_per_solve")
    size = drill.BA_SIZES["small"]
    problem = drill.ba_problem(size["cams"], size["pts"], size["seed"], size["sigma"])
    want = ba.solve_sharded(problem, make_mesh(8, 1, devices=["cpu"] * 8), iters=size["iters"],
                            cg_iters=size["cg"])
    _check_ranks_bit_equal("ba", tmp_path, want)
    fields = _ba_problem_np()
    np.testing.assert_allclose(np_(problem.uv), fields["uv"], atol=1e-3)  # the same problem
    ref_problem = ref_ba.BAProblem(**{k: jnp.asarray(v) for k, v in fields.items()})
    ref = ref_ba.solve(ref_problem, iters=4, cg_iters=8)
    c0 = float(ref_ba._cost(ref_problem, ref_problem.poses, ref_problem.points))
    for r in range(2):
        got = np.load(tmp_path / f"ba_r{r}.npz")
        np.testing.assert_allclose(got["poses"], np.asarray(ref.poses), atol=5e-3)
        np.testing.assert_allclose(got["points"], np.asarray(ref.points), atol=5e-3)
        assert float(got["cost"]) < 1e-2 * c0


def test_two_process_ba_over_tile_replicas(match_drills):
    """BA over ``data=1, tile=8`` across the processes: rank 1 owns no
    observation shard (its inputs all NaN), joins every gather with no
    partials and holds the same state as rank 0, equal bit for bit to the
    one-process solve on a mesh of the same shape."""
    _, tmp_path = match_drills
    size = drill.BA_SIZES["small"]
    problem = drill.ba_problem(size["cams"], size["pts"], size["seed"], size["sigma"])
    want = ba.solve_sharded(problem, make_mesh(1, 8, devices=["cpu"] * 8), iters=size["iters"],
                            cg_iters=size["cg"])
    for r in range(2):
        got = np.load(tmp_path / f"ba_r{r}.npz")
        for name in want._fields:
            np.testing.assert_array_equal(got[f"replica_{name}"], np_(getattr(want, name)),
                                          err_msg=f"replica rank {r} {name}")


@pytest.mark.parametrize("mode, rc1", [("failure", 42), ("hung", 44)])
def test_two_process_peer_loss_detected(tmp_path, mode, rc1):
    """A peer that dies (``failure``) or sleeps past the heartbeat
    (``hung``) makes rank 0's next barrier raise; rank 0 reports it and
    exits 0."""
    outs = _run_drill(mode, tmp_path, (0, rc1), ("--heartbeat", str(HEARTBEAT_S)))
    assert f"peer {'failure' if mode == 'failure' else 'hang'} detected" in outs[0], outs[0]
    n = _numbers(outs[0], mode)
    assert n["detect_s"] <= HEARTBEAT_S + 10
    if mode == "failure":
        assert n["since_death_s"] is not None and n["since_death_s"] <= HEARTBEAT_S + 10
    else:  # a hang is told by the timeout, not by a closed connection
        assert n["detect_s"] >= HEARTBEAT_S - 0.5


def test_two_process_supervised_resume_shrunken_mesh(tmp_path, capfd):
    """Rank 1 dies after the first checkpointed BA segment; rank 0's next
    collective fails (no result); the supervisor relaunches the survivor
    alone, which resumes from its checkpoint on the 4 slots it has
    (``resumable.auto_mesh``) and completes."""
    outs = _run_drill("resumable", tmp_path, (1, 43), env=_env(STEPTH_DIE_AT="2"))
    assert "resumable drill OK" not in outs[0], outs[0]
    assert (tmp_path / "ba_resumable_p0.npz").exists(), outs[0]
    logs = []
    rc = supervisor.supervise(lambda attempt: _argv(0, 1, 0, "resumable", tmp_path),
                              max_restarts=1, backoff_s=0.01, env=_env(),
                              attempt_timeout_s=TIMEOUT_S, log=logs.append)
    assert rc == 0, logs
    printed = capfd.readouterr().out
    assert "[rank 0] resuming from iteration 2 on a 4-shard mesh" in printed, printed
    final = np.load(tmp_path / "final_p0.npz")
    assert float(final["cost"]) < 1e-4, final["cost"]

"""The port's resumable bundle adjustment (``fusion.resumable``), its
checkpoints and the process supervisor, on the port alone (the reference's
drills of tests/test_failure_recovery.py, with torch workers).

Every reduction of the port's BA is deterministic, so 5 + 5 iterations equal
10 bit for bit, and a ``solve_resumable`` interrupted anywhere (in-process,
or by killing its process under ``supervise``) and rerun equals a straight
``solve`` bit for bit. Workers run torch on one thread, as the tests do:
CPU reductions split by thread count."""

import os
import sys

import numpy as np
import pytest
import torch

from stepth_tpu.fusion import resumable as ref_resumable
from stepth_tpu_torch.fusion import ba, resumable
from stepth_tpu_torch.utils import checkpoint, supervisor

from tests.test_fusion_ba import make_problem
from tests.torch_port import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _problem(rng, **kw):
    ref, _, _ = make_problem(rng, **{"n_cams": 4, "n_pts": 40, "perturb": 0.05, **kw})
    arrays = {k: np.asarray(v) for k, v in ref._asdict().items()}
    return ref, arrays, ba.problem_from_arrays(arrays, device="cpu")


def _equal(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_five_plus_five_is_ten(rng):
    _, _, problem = _problem(rng)
    half = ba.solve(problem, iters=5, cg_iters=8)
    rest = ba.solve(problem._replace(poses=half.poses, points=half.points), iters=5,
                    cg_iters=8, lm_lambda0=float(half.lm_lambda))
    _equal(rest, ba.solve(problem, iters=10, cg_iters=8))


def test_interrupt_resume_bit_equal(rng, tmp_path):
    _, _, problem = _problem(rng)
    ckpt = str(tmp_path / "resumable.npz")

    class Die(Exception):
        pass

    def killer(done, state):
        if done == 4:
            raise Die()  # after the segment's checkpoint

    with pytest.raises(Die):
        resumable.solve_resumable(problem, ckpt, iters=10, cg_iters=8, every=2,
                                  on_segment=killer)
    meta = checkpoint.metadata(ckpt)
    assert meta["iter"] == 4 and meta["total_iters"] == 10 and meta["n_devices"] == 1
    st = resumable.solve_resumable(problem, ckpt, iters=10, cg_iters=8, every=2)
    straight = ba.solve(problem, iters=10, cg_iters=8)
    _equal(st, straight)
    again = resumable.solve_resumable(problem, ckpt, iters=10, cg_iters=8, every=2)
    _equal(again, straight)  # a completed checkpoint restores as it is


def test_sharded_resume_bit_equal(rng, tmp_path):
    """On a mesh from ``auto_mesh`` (4 CPU devices, N = 160)."""
    _, _, problem = _problem(rng)
    mesh = resumable.auto_mesh(problem.uv.shape[0], devices=["cpu"] * 4)
    assert mesh.shape == {"data": 4, "tile": 1}
    ckpt = str(tmp_path / "sharded.npz")

    class Die(Exception):
        pass

    def killer(done, state):
        if done == 2:
            raise Die()

    with pytest.raises(Die):
        resumable.solve_resumable(problem, ckpt, iters=4, cg_iters=8, every=2, mesh=mesh,
                                  on_segment=killer)
    assert checkpoint.metadata(ckpt)["n_devices"] == 4
    st = resumable.solve_resumable(problem, ckpt, iters=4, cg_iters=8, every=2, mesh=mesh)
    _equal(st, ba.solve_sharded(problem, mesh, iters=4, cg_iters=8))


def test_auto_mesh():
    assert resumable.auto_mesh(63, devices=["cpu"] * 8).shape["data"] == 7
    assert resumable.auto_mesh(61, devices=["cpu"] * 8) is None  # prime: one device
    assert resumable.auto_mesh(64, devices=["cpu"]) is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resumable.auto_mesh(64)


def test_fingerprint_is_the_references(rng):
    ref, _, problem = _problem(rng)
    assert resumable._problem_fingerprint(problem) == ref_resumable._problem_fingerprint(ref)


def test_stale_checkpoint_rejected(rng, tmp_path):
    _, _, prob_a = _problem(rng)
    _, _, prob_b = _problem(rng)
    assert not torch.equal(prob_a.uv, prob_b.uv)
    ckpt = str(tmp_path / "stale.npz")
    resumable.solve_resumable(prob_a, ckpt, iters=6, cg_iters=8, every=2)
    st_b = resumable.solve_resumable(prob_b, ckpt, iters=6, cg_iters=8, every=2)
    _equal(st_b, ba.solve(prob_b, iters=6, cg_iters=8))


def test_save_is_atomic_and_corruption_restarts(rng, tmp_path):
    ckpt = str(tmp_path / "atomic.npz")
    checkpoint.save(ckpt, {"poses": torch.ones(4, 6), "lm": torch.tensor(2.0)},
                    metadata={"iter": 3})
    assert checkpoint.metadata(ckpt) == {"iter": 3}
    assert sorted(os.listdir(tmp_path)) == ["atomic.npz"]  # no temporary left
    with open(ckpt, "r+b") as f:
        f.truncate(40)
    assert checkpoint.metadata(ckpt) is None

    _, _, problem = _problem(rng)
    ckpt2 = str(tmp_path / "solve.npz")
    resumable.solve_resumable(problem, ckpt2, iters=4, cg_iters=8, every=2)
    with open(ckpt2, "r+b") as f:
        f.truncate(40)
    st = resumable.solve_resumable(problem, ckpt2, iters=4, cg_iters=8, every=2)
    _equal(st, ba.solve(problem, iters=4, cg_iters=8))
    with pytest.raises(ValueError, match="every"):
        resumable.solve_resumable(problem, ckpt2, iters=4, every=0)


_WORKER = r"""
import os, sys
sys.path.insert(0, sys.argv[3])
import numpy as np
import torch
torch.set_num_threads(1)
from stepth_tpu_torch.fusion import ba, resumable

ckpt, out, die_at = sys.argv[1], sys.argv[2], int(sys.argv[4])
arrays = dict(np.load(os.path.join(os.path.dirname(ckpt), "problem.npz")))
problem = ba.problem_from_arrays(arrays, device="cpu")

def hook(done, state):
    if done == die_at:
        os._exit(17)  # preemption: no cleanup

st = resumable.solve_resumable(problem, ckpt, iters=10, cg_iters=8, every=2, on_segment=hook)
np.savez(out, poses=st.poses.numpy(), points=st.points.numpy())
"""


def test_supervisor_relaunches_torch_worker(rng, tmp_path):
    """The worker process dies after iteration 2, then after 6; the
    supervisor relaunches it and the result equals a straight solve."""
    _, arrays, problem = _problem(rng)
    np.savez(tmp_path / "problem.npz", **arrays)
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    ckpt = str(tmp_path / "sup.npz")
    out = str(tmp_path / "final.npz")

    def argv(attempt):
        return [sys.executable, str(worker), ckpt, out, REPO,
                {0: "2", 1: "6"}.get(attempt, "-1")]

    logs = []
    env = dict(os.environ, PYTHONPATH=REPO)
    rc = supervisor.supervise(argv, max_restarts=3, backoff_s=0.01, env=env,
                              attempt_timeout_s=300, log=logs.append)
    assert rc == 0, logs
    assert any("recovered after 2 restart(s)" in m for m in logs), logs
    final = np.load(out)
    straight = ba.solve(problem, iters=10, cg_iters=8)
    np.testing.assert_array_equal(final["poses"], straight.poses.numpy())
    np.testing.assert_array_equal(final["points"], straight.points.numpy())
    rc = supervisor.supervise([sys.executable, "-c", "raise SystemExit(3)"], max_restarts=1,
                              backoff_s=0.0, log=logs.append)
    assert rc == 3 and "giving up" in logs[-1]

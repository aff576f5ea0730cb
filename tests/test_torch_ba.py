"""The port's bundle adjustment (``fusion.ba``) against the JAX package's,
on ``tests/test_fusion_ba.py::make_problem`` carried across as numpy arrays
(``ba.problem_from_arrays``).

Residuals, Jacobian blocks, ``_segsum`` (both branches, empty segments),
``_inv3`` and ``_inv_spd`` agree within 1e-5 of each output's scale: the
two libraries' forward-mode derivatives and sums differ by a few ulp.
``solve`` (l2, huber, cauchy, padded slots) and ``solve_sharded`` on
``["cpu"] * 8`` are held to the JAX package's own rule for a changed
reduction order (tests/test_fusion_ba.py:97-101): poses and points within
5e-3, cost within rtol 0.3, atol 1e-4. ``cg_convergence``: the same
history within rtol 1e-3 until the reference's relative residual first
falls below 1e-3; past that both are at the f32 rounding floor, where CG's
steps are noise, and the port's gap to the reference stays within the
reference's own largest gap to itself over 20 reorderings of the
observations (a changed summation order), which is capped at what it
measured."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stepth_tpu.fusion import ba as ref_ba
from stepth_tpu.parallel import mesh as ref_mesh
from stepth_tpu_torch.fusion import ba
from stepth_tpu_torch.parallel.mesh import make_mesh

from tests.test_fusion_ba import make_problem
from tests.torch_port import np_, one_torch_thread  # noqa: F401 (autouse fixture)


def _port(problem):
    return ba.problem_from_arrays({k: np.asarray(v) for k, v in problem._asdict().items()},
                                  device="cpu")


def _scaled_close(got, want, rtol=1e-5):
    want = np_(want)
    np.testing.assert_allclose(np_(got), want, rtol=rtol,
                               atol=rtol * max(float(np.abs(want).max()), 1e-30))


def test_residuals_and_jacobian_blocks(rng):
    problem, _, _ = make_problem(rng, n_cams=4, n_pts=64, perturb=0.05)
    p = _port(problem)
    assert p.cam_idx.dtype == torch.int32 and p.uv.dtype == torch.float32
    _scaled_close(ba.residuals(p, p.poses, p.points),
                  jax.jit(ref_ba.residuals)(problem, problem.poses, problem.points))
    for got, want in zip(ba._jacobian_blocks(p, p.poses, p.points),
                         jax.jit(ref_ba._jacobian_blocks)(problem, problem.poses,
                                                          problem.points)):
        assert tuple(got.shape) == tuple(want.shape)
        _scaled_close(got, want)


@pytest.mark.parametrize("shape,segments", [((4096, 6, 6), 37), ((2048, 3, 3), 9000),
                                            ((3000, 12), 6000)])
def test_segsum_branches(rng, shape, segments):
    """The one-hot product (37 segments), the sorted reduction past 8192
    segments, and past the one-hot element limit (3000 rows x 6000)."""
    x = rng.normal(size=shape).astype(np.float32)
    idx = rng.integers(0, segments, shape[0]).astype(np.int32)
    want = jax.ops.segment_sum(jnp.asarray(x), jnp.asarray(idx), num_segments=segments)
    seg = ba._segments(torch.from_numpy(idx), segments)
    assert (seg.order is None) == (segments == 37)
    got = ba._segsum(torch.from_numpy(x), torch.from_numpy(idx), segments, seg)
    assert tuple(got.shape) == (segments,) + shape[1:]
    _scaled_close(got, want)
    _scaled_close(got, ref_ba._segsum(jnp.asarray(x), jnp.asarray(idx), segments))
    # deterministic by design: the same bits again, and the sorted path adds
    # each segment's rows one after another in their order
    assert torch.equal(got, ba._segsum(torch.from_numpy(x), torch.from_numpy(idx), segments))
    if seg.order is not None:
        flat = x.reshape(shape[0], -1)
        seq = np.zeros((segments, flat.shape[1]), np.float32)
        for row, s in zip(flat, idx):
            seq[s] = seq[s] + row
        np.testing.assert_array_equal(np_(got).reshape(segments, -1), seq)


@pytest.mark.parametrize("segments", [7, 9000])
def test_segsum_empty_segments_are_zero(segments):
    x = torch.ones(8, 3)
    idx = torch.tensor([0, 0, 2, 2, 2, 5, 5, 5], dtype=torch.int32)
    out = np_(ba._segsum(x, idx, segments))
    want = np_(ref_ba._segsum(jnp.ones((8, 3)), jnp.asarray(np_(idx)), segments))
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(out[[1, 3, 4, 6]], 0.0)
    np.testing.assert_array_equal(out[2], 3.0)


def test_inverses(rng):
    m = rng.normal(size=(64, 3, 3)).astype(np.float32)
    spd3 = np.einsum("pij,pkj->pik", m, m) + 0.1 * np.eye(3, dtype=np.float32)
    _scaled_close(ba._inv3(torch.from_numpy(spd3)), ref_ba._inv3(jnp.asarray(spd3)))
    m = rng.normal(size=(16, 6, 6)).astype(np.float32)
    spd6 = np.einsum("pij,pkj->pik", m, m) + 0.5 * np.eye(6, dtype=np.float32)
    _scaled_close(ba._inv_spd(torch.from_numpy(spd6)), ref_ba._inv_spd(jnp.asarray(spd6)))
    bad = np.zeros((1, 6, 6), np.float32)  # not positive definite: NaN, no exception
    assert np.isnan(np_(ba._inv_spd(torch.from_numpy(bad)))).all()


def _corrupt(rng, problem):
    """tests/test_fusion_ba.py::test_sharded_huber_matches_single_device's
    outliers: 8 observations 100 px off, under which the reference holds its
    own changed-order solves to the 5e-3 rule (4 LM iterations)."""
    uv = np.asarray(problem.uv).copy()
    uv[rng.choice(uv.shape[0], size=8, replace=False)] += 100.0
    return problem._replace(uv=jnp.asarray(uv))


def _padded(rng, problem):
    n_pad = 64
    return problem._replace(
        cam_idx=jnp.concatenate([problem.cam_idx, jnp.zeros(n_pad, jnp.int32)]),
        pt_idx=jnp.concatenate([problem.pt_idx, jnp.zeros(n_pad, jnp.int32)]),
        uv=jnp.concatenate([problem.uv, jnp.asarray(rng.uniform(0, 640, (n_pad, 2)),
                                                    jnp.float32)]),
        weight=jnp.concatenate([problem.weight, jnp.zeros(n_pad, jnp.float32)]))


def _same_solution(got, want):
    """tests/test_fusion_ba.py:97-101's rule."""
    np.testing.assert_allclose(np_(got.poses), np_(want.poses), atol=5e-3)
    np.testing.assert_allclose(np_(got.points), np_(want.points), atol=5e-3)
    np.testing.assert_allclose(float(got.cost), float(want.cost), rtol=0.3, atol=1e-4)


@pytest.mark.parametrize("case", ["l2", "huber", "cauchy", "padded"])
def test_solve_matches_reference(rng, case):
    problem, _, _ = make_problem(rng, n_cams=4, n_pts=64, perturb=0.03)
    kw = dict(iters=8, cg_iters=10)
    if case in ("huber", "cauchy"):
        problem = _corrupt(rng, problem)
        kw = dict(iters=4, cg_iters=8, loss=case, loss_delta=4.0)
    elif case == "padded":
        problem = _padded(rng, problem)
    want = ref_ba.solve(problem, **kw)
    got = ba.solve(_port(problem), **kw)
    assert got.poses.dtype == torch.float32 and got.lm_lambda.shape == ()
    _same_solution(got, want)
    c0 = float(ref_ba._cost(problem, problem.poses, problem.points, kw.get("loss", "l2"), 4.0))
    assert float(got.cost) < c0 * (0.5 if "loss" in kw else 1e-2)


@pytest.mark.parametrize("loss", ["l2", "huber"])
def test_solve_sharded_matches_reference(rng, loss):
    problem, _, _ = make_problem(rng, n_cams=4, n_pts=64, perturb=0.03)  # N=256
    if loss == "huber":
        problem = _corrupt(rng, problem)
    kw = dict(iters=4, cg_iters=8, loss=loss, loss_delta=4.0)
    want = ref_ba.solve_sharded(problem, ref_mesh.make_mesh(data=8, tile=1), **kw)
    mesh = make_mesh(data=8, tile=1, devices=["cpu"] * 8)
    got = ba.solve_sharded(_port(problem), mesh, **kw)
    _same_solution(got, want)
    _same_solution(got, ba.solve(_port(problem), **kw))
    # one shard is the single-device solve, bit for bit
    one = ba.solve_sharded(_port(problem), make_mesh(data=1, tile=1, devices=["cpu"]), **kw)
    for a, b in zip(one, ba.solve(_port(problem), **kw)):
        assert torch.equal(a, b)


def test_sharded_obs_count_validation(rng):
    problem, _, _ = make_problem(rng, n_cams=3, n_pts=21, perturb=0.02)  # N=63
    with pytest.raises(ValueError, match="not divisible"):
        ba.solve_sharded(_port(problem), make_mesh(data=8, tile=1, devices=["cpu"] * 8),
                         iters=2, cg_iters=4)


# The reference's own CG history against itself with the observations in 20
# other orders (rng seeds 0-19): the largest gap past the floor, measured on
# this problem (1.018e-05 preconditioned, 2.964e-03 plain) and capped here.
CG_REORDERINGS = 20
CG_SELF_GAP_CAP = {True: 1.1e-5, False: 3.0e-3}


def _reordered(problem, seed):
    order = np.random.default_rng(seed).permutation(problem.cam_idx.shape[0])
    return problem._replace(**{k: getattr(problem, k)[order]
                               for k in ("cam_idx", "pt_idx", "uv", "weight")})


@pytest.mark.parametrize("use_precond", [True, False])
def test_cg_convergence_history(rng, use_precond):
    problem, _, _ = make_problem(rng, n_cams=4, n_pts=64, perturb=0.03)
    want = np_(ref_ba.cg_convergence(problem, cg_iters=12, use_precond=use_precond))
    got = np_(ba.cg_convergence(_port(problem), cg_iters=12, use_precond=use_precond))
    assert got.shape == want.shape == (13,)
    floor = int(np.argmax(want < 1e-3))
    assert floor >= 3
    np.testing.assert_allclose(got[:floor], want[:floor], rtol=1e-3)
    # past the floor CG's steps are rounding noise: the port's gap stays
    # within the reference's own gap under another summation order
    self_gap = max(
        float(np.abs(np_(ref_ba.cg_convergence(_reordered(problem, seed), cg_iters=12,
                                               use_precond=use_precond)) - want)[floor:].max())
        for seed in range(CG_REORDERINGS))
    assert self_gap <= CG_SELF_GAP_CAP[use_precond], self_gap
    assert float(np.abs(got - want)[floor:].max()) <= self_gap


def test_full_f32_products_required():
    a = torch.ones(4, 4)
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        with pytest.raises(RuntimeError, match="full-f32"):
            ba.matmul_f32(a, a)
    finally:
        torch.set_float32_matmul_precision(prev)
    assert torch.equal(ba.matmul_f32(a, a), torch.full((4, 4), 4.0))

"""The port's depth fusion and pose graph (``fusion.depthfusion``,
``fusion.posegraph``) against the JAX package's.

``warp_depth_to_ref`` is bit-equal to the reference's. ``fuse_depths`` is
bit-equal to the reference's run op by op (``jax.disable_jit``); the
reference's jitted ``fuse_depths`` lets XLA's CPU compiler contract the
geometry's products into FMAs, so its warped depths, and the fused depth,
differ from the op-by-op values in the last bit, with equal confidence
maps: the port is held within 2.4e-7 relative (2 ulp) of it. No rounding-tie flip was seen (a pixel
whose splat coordinate lands on .5 could round the other way).

The pose graph: poses within 1e-4 absolute, ``total_error`` within rtol
1e-3 (atol 1e-10: a converged chain's error is at the f32 floor, ~1e-14),
for the reference's chain and false-closure cases under l2, huber and
cauchy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stepth_tpu.fusion import depthfusion as ref_depthfusion
from stepth_tpu.fusion import geometry as ref_geo
from stepth_tpu.fusion import posegraph as ref_posegraph
from stepth_tpu_torch.fusion import depthfusion, posegraph

from tests.torch_port import np_, one_torch_thread  # noqa: F401 (autouse fixture)


def _views(rng, h=48, w=64, k=4, strafe=0.1):
    intr = np.array([60.0, 58.0, w / 2, h / 2], np.float32)
    depths = rng.uniform(2.0, 6.0, (k, h, w)).astype(np.float32)
    depths[0, :3] = 0.0  # no depth: nothing splats
    depths[1, 5, 5] = 1e-4  # below the 1e-3 floor
    poses = np.stack([[0.0, 0.01 * i, -0.005 * i, strafe * i, 0.02 * i, 0.01 * i]
                      for i in range(k)]).astype(np.float32)
    return depths, poses, intr


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_warp_bit_equal(seed):
    rng = np.random.default_rng(seed)
    depths, poses, intr = _views(rng)
    for k in range(depths.shape[0]):
        for ref in (poses[0], poses[-1]):
            want = ref_depthfusion.warp_depth_to_ref(
                jnp.asarray(depths[k]), jnp.asarray(poses[k]), jnp.asarray(ref),
                jnp.asarray(intr))
            got = depthfusion.warp_depth_to_ref(depths[k], poses[k], ref, intr, device="cpu")
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(np_(got), np_(want))


def test_warp_reference_cases():
    """tests/test_fusion_depth.py's analytic cases: identity round trip and
    a fronto-parallel plane seen from a translated camera."""
    h, w = 32, 40
    intr = torch.tensor([50.0, 50.0, w / 2, h / 2])
    pose = torch.zeros(6)
    warped = depthfusion.warp_depth_to_ref(torch.full((h, w), 4.0), pose, pose, intr)
    np.testing.assert_allclose(np_(warped), 4.0, atol=1e-4)
    warped = np_(depthfusion.warp_depth_to_ref(torch.full((h, w), 5.0), pose,
                                               torch.tensor([0.0, 0, 0, 0.5, 0, 0]), intr))
    assert (warped > 0).mean() > 0.8
    np.testing.assert_allclose(warped[warped > 0], 5.0, atol=1e-3)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fuse_depths_bit_equal_op_by_op(seed):
    rng = np.random.default_rng(seed)
    depths, poses, intr = _views(rng)
    args = [jnp.asarray(a) for a in (depths, poses, poses[0], intr)]
    with jax.disable_jit():
        want = ref_depthfusion.fuse_depths(*args)
    jitted = ref_depthfusion.fuse_depths(*args)
    got = depthfusion.fuse_depths(depths, poses, poses[0], intr, device="cpu")
    np.testing.assert_array_equal(np_(got.depth), np_(want.depth))
    np.testing.assert_array_equal(np_(got.confidence), np_(want.confidence))
    np.testing.assert_allclose(np_(got.depth), np_(jitted.depth), rtol=2.4e-7, atol=0)
    np.testing.assert_array_equal(np_(got.confidence), np_(jitted.confidence))
    assert np_(got.confidence).max() >= 3  # views agree somewhere


def test_fuse_depths_consensus_and_empty():
    h, w = 24, 30
    intr = np.array([40.0, 40.0, w / 2, h / 2], np.float32)
    pose = np.zeros(6, np.float32)
    base = np.full((h, w), 3.0, np.float32)
    depths = np.stack([base, base * 1.005, base * 3.0])  # two agree, one far
    poses = np.stack([pose] * 3)
    for d in (depths, np.zeros((2, 8, 10), np.float32)):
        i = intr if d.shape[1] == h else np.array([40.0, 40.0, 5.0, 4.0], np.float32)
        ps = poses[: d.shape[0]]
        want = ref_depthfusion.fuse_depths(jnp.asarray(d), jnp.asarray(ps), jnp.asarray(pose),
                                           jnp.asarray(i), rel_tol=0.02)
        got = depthfusion.fuse_depths(d, ps, pose, i, rel_tol=0.02, device="cpu")
        np.testing.assert_array_equal(np_(got.depth), np_(want.depth))
        np.testing.assert_array_equal(np_(got.confidence), np_(want.confidence))
    assert (np_(got.depth) == 0).all() and (np_(got.confidence) == 0).all()


def _graph(rng, false_closure):
    """tests/test_fusion_depth.py's chain (+ the false closure)."""
    m = 6
    gt = jnp.asarray(np.stack([
        np.concatenate([rng.normal(0, 0.1, 3), np.array([i * 1.0, 0.0, 0.0])]).astype(np.float32)
        for i in range(m)]))
    ei, ej, meas = [], [], []
    for i in range(m - 1):
        ei.append(i), ej.append(i + 1)
        meas.append(ref_geo.relative(gt[i], gt[i + 1]))
    ei.append(0), ej.append(m - 1)
    meas.append(ref_geo.relative(gt[0], gt[m - 1]))
    if false_closure:
        ei.append(1), ej.append(4)
        meas.append(jnp.asarray(np.array([0, 0, 0, 1.0, 0, 0], np.float32)))
    noisy = np.asarray(gt) + rng.normal(0, 0.03 if false_closure else 0.05,
                                        (m, 6)).astype(np.float32)
    noisy[0] = np.asarray(gt[0])
    graph = ref_posegraph.PoseGraph(
        poses=jnp.asarray(noisy), edge_i=jnp.asarray(ei, jnp.int32),
        edge_j=jnp.asarray(ej, jnp.int32), measurements=jnp.stack(meas),
        weights=jnp.ones(len(ei), jnp.float32))
    return graph, np.asarray(gt)


@pytest.mark.parametrize("case", ["chain", "false closure"])
@pytest.mark.parametrize("loss", ["l2", "huber", "cauchy"])
def test_posegraph_matches_reference(rng, case, loss):
    ref_graph, gt = _graph(rng, case == "false closure")
    graph = posegraph.graph_from_arrays({k: np.asarray(v) for k, v in ref_graph._asdict().items()},
                                        device="cpu")
    assert graph.edge_i.dtype == torch.int32
    iters = 20 if case == "false closure" else 15
    want = ref_posegraph.optimize(ref_graph, iters=iters, loss=loss, loss_delta=0.1)
    got = posegraph.optimize(graph, iters=iters, loss=loss, loss_delta=0.1)
    np.testing.assert_allclose(np_(got), np_(want), atol=1e-4, rtol=0)
    for poses_ref, poses in ((ref_graph.poses, graph.poses), (want, got)):
        np.testing.assert_allclose(float(posegraph.total_error(graph, poses)),
                                   float(ref_posegraph.total_error(ref_graph, poses_ref)),
                                   rtol=1e-3, atol=1e-10)
    err = float(np.abs(np_(got) - gt).max())
    if case == "chain":
        np.testing.assert_allclose(np_(got), gt, atol=5e-3)
    elif loss == "cauchy":
        assert err < 0.02, err  # the false edge suppressed
    with pytest.raises(ValueError, match="loss"):
        posegraph.optimize(graph, iters=1, loss="tukey")

"""The mapping path (``tools/mapping_bench.py``, config 5) through the port
against the JAX package's, at 4 keyframes and 96×128: the production
matcher's ``video(4)`` (census, LR; the port's plain kernels on the CPU,
the reference's Pallas kernels in interpret mode), metric depth,
``fuse_depths``, the pose graph and ``solve_resumable``, on one world made
once from seeded numpy (``chip_smoke.mapping_world``) and run by
``chip_smoke.mapping_run``, the function phase 7a drives on the card.

The focal length is scaled with the width (1000 px at 1920 columns), so
that the small clip keeps the 1088×1920 run's field of view: at f = 1000 px
a 128-column view spans 7°, the poses' rotations and translations trade
off, the points' depths are weakly observed, and the JAX package's own
``solve`` and ``solve_sharded`` differ there by 4.5e-2.

Rules: disparity and validity equal; the fused depth within 2.4e-7
relative of the reference's jitted ``fuse_depths`` (its FMA contraction,
see tests/test_torch_fusion_depth.py) with equal confidence; poses within
1e-4 and the pose-graph error within rtol 1e-3 (atol 1e-10); BA poses and
points within the JAX package's 5e-3 rule and the cost within rtol 0.3,
atol 1e-4."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import torch

from stepth_tpu.config import MatchConfig as RefMatchConfig
from stepth_tpu.config import PyramidConfig as RefPyramidConfig
from stepth_tpu.fusion import ba as ref_ba
from stepth_tpu.fusion import depthfusion as ref_depthfusion
from stepth_tpu.fusion import geometry as ref_geo
from stepth_tpu.fusion import posegraph as ref_posegraph
from stepth_tpu.fusion import resumable as ref_resumable
from stepth_tpu.models.stereo import StereoModel as RefStereoModel

from tests.torch_port import np_, one_torch_thread  # noqa: F401 (autouse fixture)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

H, W, KEYFRAMES, DMAX, LEVELS, COARSEST, POINTS = 96, 128, 4, 32, 3, 8, 256
F = chip_smoke.MAP_F * W / 1920  # the 1088x1920 run's field of view


def _reference_run(world, ckpt):
    """tools/mapping_bench.py's stages through the JAX package."""
    cs = chip_smoke
    rng = np.random.default_rng(cs.MAP_SEED)
    poses = jnp.asarray(world["poses"])
    intr = jnp.asarray(world["intr"])
    model = RefStereoModel(backend="hierarchical-pallas",
                           match=RefMatchConfig(num_disparities=DMAX, window=9, cost="census"),
                           pyramid=RefPyramidConfig(levels=LEVELS, coarsest_disparities=COARSEST),
                           lr_check=True)
    res = model.video(keyframe_interval=4)(jnp.asarray(world["lefts"]),
                                           jnp.asarray(world["rights"]))
    disp, valid = np.asarray(res.disparity), np.asarray(res.valid)
    fb = float(world["intr"][0]) * cs.MAP_B
    depths = jnp.asarray(np.where(valid, fb / np.maximum(disp, 1e-3), 0.0).astype(np.float32))
    fused = ref_depthfusion.fuse_depths(depths, poses, poses[0], intr)
    noisy = poses + jnp.asarray(rng.normal(0, 0.01, (KEYFRAMES, 6)).astype(np.float32))
    noisy = noisy.at[0].set(poses[0])
    ei = jnp.asarray(list(range(KEYFRAMES - 1)) + [0], jnp.int32)
    ej = jnp.asarray(list(range(1, KEYFRAMES)) + [KEYFRAMES - 1], jnp.int32)
    graph = ref_posegraph.PoseGraph(noisy, ei, ej, ref_geo.relative(poses[ei], poses[ej]),
                                    jnp.ones(KEYFRAMES, jnp.float32))
    opt = ref_posegraph.optimize(graph, iters=10)
    ys = rng.integers(8, H - 8, POINTS)
    xs = rng.integers(8, W - 8, POINTS)
    z = jnp.asarray(world["z0"][ys, xs])
    uv0 = jnp.asarray(np.stack([xs, ys], -1).astype(np.float32))
    pts = ref_geo.transform(ref_geo.inverse(poses[0])[None], ref_geo.unproject(uv0, z, intr))
    ci = jnp.asarray(np.repeat(np.arange(KEYFRAMES), POINTS), jnp.int32)
    pi = jnp.asarray(np.tile(np.arange(POINTS), KEYFRAMES), jnp.int32)
    uv = ref_geo.project(ref_geo.transform(poses[ci], pts[pi]), intr)
    uv = uv + jnp.asarray(rng.normal(0, cs.MAP_SIGMA, uv.shape).astype(np.float32))
    prob = ref_ba.BAProblem(
        poses=opt, points=pts + jnp.asarray(rng.normal(0, 0.002, pts.shape).astype(np.float32)),
        intrinsics=intr, cam_idx=ci, pt_idx=pi, uv=uv,
        weight=jnp.ones(KEYFRAMES * POINTS, jnp.float32))
    state = ref_resumable.solve_resumable(prob, ckpt, iters=cs.MAP_LM, cg_iters=cs.MAP_CG,
                                          every=cs.MAP_EVERY)
    return dict(match=res, fused=fused, graph=graph, opt=opt, ba=state)


def test_mapping_pipeline_matches_reference(tmp_path):
    cpu = torch.device("cpu")
    world = chip_smoke.mapping_world(H, W, KEYFRAMES, DMAX, cpu, f=F)
    got = chip_smoke.mapping_run(world, chip_smoke.mapping_model(DMAX, LEVELS, COARSEST), cpu,
                                 str(tmp_path / "port.npz"), ba_points=POINTS)
    want = _reference_run(world, str(tmp_path / "ref.npz"))

    np.testing.assert_array_equal(np_(got["match"].disparity), np_(want["match"].disparity))
    np.testing.assert_array_equal(np_(got["match"].valid), np_(want["match"].valid))
    np.testing.assert_allclose(np_(got["fused"].depth), np_(want["fused"].depth),
                               rtol=2.4e-7, atol=0)
    np.testing.assert_array_equal(np_(got["fused"].confidence), np_(want["fused"].confidence))
    np.testing.assert_allclose(np_(got["opt"]), np_(want["opt"]), atol=1e-4, rtol=0)
    from stepth_tpu_torch.fusion import posegraph

    np.testing.assert_allclose(float(posegraph.total_error(got["graph"], got["opt"])),
                               float(ref_posegraph.total_error(want["graph"], want["opt"])),
                               rtol=1e-3, atol=1e-10)
    st, ref = got["ba"], want["ba"]
    np.testing.assert_allclose(np_(st.poses), np_(ref.poses), atol=5e-3)
    np.testing.assert_allclose(np_(st.points), np_(ref.points), atol=5e-3)
    np.testing.assert_allclose(float(st.cost), float(ref.cost), rtol=0.3, atol=1e-4)

    # the stages' own checks, as phase 7a makes them on the card
    acc = chip_smoke.depth_accuracy(world, got)
    assert acc["fused_median"] < acc["single_median"], acc
    assert float(st.cost) < 1.5 * 2 * chip_smoke.MAP_SIGMA ** 2
    assert set(got["stages"].summary()) == {"match", "fuse", "pose graph", "bundle adjustment"}

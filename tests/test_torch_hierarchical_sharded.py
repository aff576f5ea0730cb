"""The sharded hierarchical paths (``parallel/sharded.py``): the pyramid on
row shards, its batched and temporal variants, against the port's unsharded
twins (``fused_refine``) with the refine plans compared level by level, and
against the JAX package's ``match_hierarchical_sharded`` (interpret mode,
the 8-fake-device mesh).

Rules: exact equality on integer-valued gray images at the same effective
``tile_rows``. With ``coarse_backend="sgm"`` the sharded coarse level is the
XLA-style SGM relay, which may break exact-cost ties differently from the
fused SGM of the unsharded path (``stepth_tpu/parallel/sharded.py:279-285``),
so that pair is held to the close rule (``tests/torch_port.py``) and the
port to the JAX sharded function exactly.
"""

import numpy as np
import pytest
import torch

from stepth_tpu.config import MatchConfig as RefMatchConfig
from stepth_tpu.config import PyramidConfig as RefPyramidConfig
from stepth_tpu.match.sgm import SGMConfig as RefSGMConfig
from stepth_tpu.models.stereo import StereoModel as RefStereoModel
from stepth_tpu.parallel import mesh as ref_mesh
from stepth_tpu.parallel import sharded as ref_sharded
from stepth_tpu_torch.config import MatchConfig, PyramidConfig, SGMConfig
from stepth_tpu_torch.match import fused_refine
from stepth_tpu_torch.models.stereo import StereoModel
from stepth_tpu_torch.parallel import sharded

from tests.test_match_dense import make_pair
from tests.test_torch_sgm_pallas_sharded import assert_equal, cpu_mesh, int_pair
from tests.torch_port import assert_close, np_, one_torch_thread  # noqa: F401 (autouse)

CFG = dict(num_disparities=32, window=9, lr_threshold=1.0)
PYR = dict(levels=3, refine_radius=4, coarsest_disparities=8)


def _pair(h=128, w=256, shift=6):
    return int_pair(h, w, shift)


def _with_plans(stages, fn):
    """``fn`` of the stage table ``stages`` whose plan stage records the
    refine plans ``(bases, nw, tile_rows)`` it makes, in order; returns its
    output and the plans."""
    plans = []

    def record(*args):
        plans.append(stages.plan(*args))
        return plans[-1]

    return fn(stages._replace(plan=record)), plans


@pytest.mark.parametrize("lr_check", [False, True])
@pytest.mark.parametrize("ntile", [2, 4])
def test_equals_unsharded_with_equal_plans(ntile, lr_check):
    """Bit-equal to the unsharded plain path at ``tile_rows=8``, and every
    shard's plan of its own rows (the halo's tiles dropped) equals the
    unsharded plan's rows there, level by level."""
    left, right = _pair()
    cfg, pyr = MatchConfig(**CFG), PyramidConfig(**PYR)
    want, want_plans = _with_plans(fused_refine.PLAIN, lambda s: fused_refine._match_hierarchical(
        s, left, right, cfg, pyr, 8, lr_check, "wta", "cpu"))
    got, got_plans = _with_plans(fused_refine.FUSED, lambda s: sharded.match_hierarchical_sharded(
        left, right, cfg, pyr, cpu_mesh(ntile), tile_rows=8, lr_check=lr_check, stages=s))
    assert_equal(want, got)
    if lr_check:
        assert not bool(got.valid.all())
    assert len(want_plans) == pyr.levels - 1 and len(got_plans) == ntile * len(want_plans)
    k = 1  # halo tiles: a halo of 8 rows (window 9 needs 5) at tile_rows 8
    for lvl, (bases, nw, tr) in enumerate(want_plans):
        shards = got_plans[lvl * ntile:(lvl + 1) * ntile]
        assert all(t == tr == 8 for _, _, t in shards)
        assert torch.equal(torch.cat([b[k:-k] for b, _, _ in shards]), bases)
        assert torch.equal(torch.cat([n[k:-k] for _, n, _ in shards]), nw)


@pytest.fixture(scope="module")
def reference():
    """The JAX sharded outputs, each computed once: the ``lr_check`` case of
    ``tests/test_parallel.py:143-169`` on its own float texture, and the SGM
    coarse level on the integer pair."""
    mesh = ref_mesh.make_mesh(data=1, tile=2)
    rng = np.random.default_rng(0)
    texture = make_pair(rng, h=128, w=256, shift=6)
    return {
        "lr_check": (texture, ref_sharded.match_hierarchical_sharded(
            *texture, RefMatchConfig(**CFG), RefPyramidConfig(**PYR), mesh, tile_rows=8,
            interpret=True, lr_check=True)),
        "sgm": (_pair(), ref_sharded.match_hierarchical_sharded(
            *_pair(), RefMatchConfig(**CFG), RefPyramidConfig(**PYR), mesh, tile_rows=8,
            interpret=True, coarse_backend="sgm", sgm=RefSGMConfig(directions=4))),
    }


def test_lr_check_matches_reference(reference):
    (left, right), want = reference["lr_check"]
    got = sharded.match_hierarchical_sharded(left, right, MatchConfig(**CFG),
                                             PyramidConfig(**PYR), cpu_mesh(2), tile_rows=8,
                                             lr_check=True)
    assert_equal(want, got)


def test_sgm_coarse_level_matches_reference(reference):
    (left, right), want = reference["sgm"]
    cfg, pyr, sgm = MatchConfig(**CFG), PyramidConfig(**PYR), SGMConfig(directions=4)
    got = sharded.match_hierarchical_sharded(left, right, cfg, pyr, cpu_mesh(2), tile_rows=8,
                                             coarse_backend="sgm", sgm=sgm)
    assert_equal(want, got)
    unsharded = fused_refine.match_hierarchical_plain(left, right, cfg, pyr, tile_rows=8,
                                                      coarse_backend="sgm", sgm=sgm,
                                                      device="cpu")
    assert_close(np_(unsharded.disparity), np_(unsharded.valid), np_(got.disparity),
                 np_(got.valid))
    model = StereoModel(backend="hierarchical-sgm", match=cfg, pyramid=pyr, sgm=sgm)
    assert_equal(sharded.match_hierarchical_sharded(left, right, cfg, pyr, cpu_mesh(2),
                                                    coarse_backend="sgm", sgm=sgm),
                 model.sharded(cpu_mesh(2))(left, right))


def test_batch_hierarchical_sharded_equals_unsharded():
    """Four frames over ``data=2``: each frame is the unsharded pyramid."""
    pairs = [int_pair(64, 128, s, seed=s) for s in (4, 6, 8, 10)]
    lefts, rights = (torch.from_numpy(np.stack(p)) for p in zip(*pairs))
    cfg, pyr = MatchConfig(**CFG), PyramidConfig(**PYR)
    got = sharded.match_batch_hierarchical_sharded(lefts, rights, cfg, pyr,
                                                   cpu_mesh(1, data=2), tile_rows=8,
                                                   lr_check=True)
    assert got.disparity.shape == (4, 64, 128)
    for i in range(4):
        want = fused_refine.match_hierarchical_plain(lefts[i], rights[i], cfg, pyr,
                                                     tile_rows=8, lr_check=True)
        assert_equal(want, type(want)(*(f[i] for f in got)))


@pytest.mark.parametrize("lr_check", [False, True])
def test_temporal_sharded_equals_unsharded(lr_check):
    """Four frames, keyframes 0 and 2, the disparity drifting 1 px a frame:
    each frame equals the unsharded video's at the same ``tile_rows``."""
    clip = [int_pair(128, 256, s, seed=0) for s in (6, 7, 8, 9)]
    lefts, rights = (torch.from_numpy(np.stack(p)) for p in zip(*clip))
    cfg, pyr = MatchConfig(**CFG), PyramidConfig(**PYR)
    want = fused_refine.match_temporal_plain(lefts, rights, cfg, pyr, 2, tile_rows=8,
                                             lr_check=lr_check)
    got = sharded.match_temporal_sharded(lefts, rights, cfg, pyr, cpu_mesh(2),
                                         keyframe_interval=2, tile_rows=8, lr_check=lr_check)
    assert_equal(want, got)


def test_model_sharded_matches_reference_with_lr_check():
    """``StereoModel(..., lr_check=True).sharded(mesh)`` equals the JAX
    package's (Pallas in interpret mode) on the same inputs: both drop
    ``lr_check`` on the sharded hierarchical path."""
    left, right = _pair()
    model = StereoModel(backend="hierarchical-pallas", match=MatchConfig(**CFG),
                        pyramid=PyramidConfig(**PYR), lr_check=True)
    ref = RefStereoModel(backend="hierarchical-pallas", match=RefMatchConfig(**CFG),
                         pyramid=RefPyramidConfig(**PYR), lr_check=True)
    want = ref.sharded(ref_mesh.make_mesh(data=1, tile=2))(left, right)
    got = model.sharded(cpu_mesh(2))(left, right)
    assert_equal(want, got)
    assert bool(got.valid.all())  # no LR check ran


@pytest.mark.parametrize("h, ntile, window, pyr, lr_check", [
    (100, 4, 9, PYR, False),  # H % tiles
    (120, 4, 9, PYR, False),  # a shard height of 30 does not divide by 2^(levels-1)
    (96, 4, 9, PYR, False),  # the coarsest shard height 6 takes no tile_rows ≤ 8
    (128, 2, 33, PYR, False),  # the coarsest shard height 16 < halo 24
    (64, 2, 9, dict(PYR, levels=1), True),  # lr_check needs a refine level
])
def test_reference_errors(h, ntile, window, pyr, lr_check):
    """The port rejects the shapes the reference rejects."""
    left, right = int_pair(h, 256, 6)
    cfg = dict(CFG, window=window)
    with pytest.raises(ValueError):
        ref_sharded.match_hierarchical_sharded(
            left, right, RefMatchConfig(**cfg), RefPyramidConfig(**pyr),
            ref_mesh.make_mesh(data=1, tile=ntile), tile_rows=8, interpret=True,
            lr_check=lr_check)
    with pytest.raises(ValueError):
        sharded.match_hierarchical_sharded(left, right, MatchConfig(**cfg),
                                           PyramidConfig(**pyr), cpu_mesh(ntile),
                                           tile_rows=8, lr_check=lr_check)

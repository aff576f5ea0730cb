"""The window-sharded paths and the plain-torch SGM relay
(``parallel/sharded.py``, ``parallel/sgm_sharded.py``) against the JAX
package's sharded functions on the 8-fake-device mesh, and against the
port's unsharded twins.

Rule: exact equality. The inputs are integer-valued gray images, so every
cost, box sum and path sum is an exact f32 integer, whatever order the adds
take in either package; the dense and SGM functions here are XLA in the
reference, and K1 runs in interpret mode.
"""

import numpy as np
import pytest
import torch

from stepth_tpu.config import MatchConfig as RefMatchConfig
from stepth_tpu.match.sgm import SGMConfig as RefSGMConfig
from stepth_tpu.parallel import mesh as ref_mesh
from stepth_tpu.parallel import sgm_sharded as ref_sgm_sharded
from stepth_tpu.parallel import sharded as ref_sharded
from stepth_tpu_torch.config import MatchConfig, SGMConfig
from stepth_tpu_torch.match import dense, fused_dense, sgm
from stepth_tpu_torch.models.stereo import StereoModel
from stepth_tpu_torch.parallel import sgm_sharded, sharded

from tests.test_torch_sgm_pallas_sharded import assert_equal, cpu_mesh, int_pair
from tests.torch_port import np_, one_torch_thread  # noqa: F401 (autouse fixture)


def _ref_mesh(ntile, data=1):
    return ref_mesh.make_mesh(data=data, tile=ntile)


@pytest.mark.parametrize("exact, ntile, ndir", [(True, 2, 4), (True, 4, 8), (False, 2, 4)])
def test_sgm_sharded_matches_reference(exact, ntile, ndir):
    """The ``sgm`` backend sharded, exact (also equal to the unsharded
    backend) and windowed (warm-up 16)."""
    left, right = int_pair()
    cfg = dict(num_disparities=16, window=5, lr_threshold=1.0)
    want = ref_sgm_sharded.match_pair_sgm_sharded(
        left, right, RefMatchConfig(**cfg), RefSGMConfig(directions=ndir), _ref_mesh(ntile),
        exact=exact, warmup=16)
    got = sgm_sharded.match_pair_sgm_sharded(left, right, MatchConfig(**cfg),
                                             SGMConfig(directions=ndir), cpu_mesh(ntile),
                                             exact=exact, warmup=16)
    assert_equal(want, got)
    if exact:
        assert_equal(sgm.match_pair_sgm(left, right, MatchConfig(**cfg),
                                        SGMConfig(directions=ndir), device="cpu"), got)


@pytest.mark.parametrize("cost", ["sad", "census"])
def test_dense_sharded_matches_reference(cost):
    left, right = int_pair()
    cfg = dict(num_disparities=16, window=9, cost=cost)
    want = ref_sharded.match_pair_sharded(left, right, RefMatchConfig(**cfg), _ref_mesh(4))
    got = sharded.match_pair_sharded(left, right, MatchConfig(**cfg), cpu_mesh(4))
    assert_equal(want, got)
    assert_equal(dense.match_pair(left, right, MatchConfig(**cfg), device="cpu"), got)


def test_batch_sharded_matches_reference():
    """Four pairs over ``data=2``, rows over ``tile=2``."""
    pairs = [int_pair(shift=s, seed=s) for s in (3, 5, 7, 9)]
    lefts, rights = (np.stack(p) for p in zip(*pairs))
    cfg = dict(num_disparities=16, window=9)
    want = ref_sharded.match_batch_sharded(lefts, rights, RefMatchConfig(**cfg),
                                           _ref_mesh(2, data=2))
    got = sharded.match_batch_sharded(torch.from_numpy(lefts), torch.from_numpy(rights),
                                      MatchConfig(**cfg), cpu_mesh(2, data=2))
    assert got.shape == lefts.shape
    np.testing.assert_array_equal(np_(got), np.asarray(want))
    for i, (left, right) in enumerate(pairs):
        one = dense.match_pair(left, right, MatchConfig(**cfg), device="cpu")
        assert torch.equal(got[i], one.disparity)


def test_pallas_sharded_matches_reference():
    """K1 per shard on its halo-extended rows (``g_row0``/``g_h``), then the
    fill and the median: the reference's, and the unsharded ``pallas``
    backend's output."""
    left, right = int_pair(h=64, w=128)
    cfg = dict(num_disparities=16, window=9, cost="sad", lr_threshold=1.0)
    want = ref_sharded.match_pair_sharded_pallas(left, right, RefMatchConfig(**cfg),
                                                 _ref_mesh(4), interpret=True)
    got = sharded.match_pair_sharded_pallas(left, right, MatchConfig(**cfg), cpu_mesh(4))
    assert_equal(want, got)
    assert_equal(fused_dense.match_pair_plain(left, right, MatchConfig(**cfg), device="cpu"),
                 got)
    assert not bool(got.valid.all())


def test_normalize_depth_sharded_matches_reference(rng):
    raw = rng.integers(0, 200, size=(64, 32)).astype(np.uint8)
    want = np.asarray(ref_sharded.normalize_depth_sharded(raw, _ref_mesh(8)))
    got = sharded.normalize_depth_sharded(raw, cpu_mesh(8))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(np_(got), want)
    zeros = np.zeros((64, 32), np.uint8)
    assert not bool(sharded.normalize_depth_sharded(torch.from_numpy(zeros), cpu_mesh(8)).any())


def test_model_sharded_dispatches_window_backends():
    left, right = int_pair()
    m = cpu_mesh(4)
    cfg = MatchConfig(num_disparities=16, window=5, lr_threshold=1.0)
    for backend, fn in (("dense", sharded.match_pair_sharded),
                        ("pallas", sharded.match_pair_sharded_pallas)):
        assert_equal(fn(left, right, cfg, m),
                     StereoModel(backend=backend, match=cfg).sharded(m)(left, right))
    model = StereoModel(backend="sgm", match=cfg, sgm=SGMConfig(directions=4))
    assert_equal(model(left, right, device="cpu"), model.sharded(m)(left, right))
    for backend in ("hierarchical", "parity"):
        with pytest.raises(NotImplementedError, match="sharded"):
            StereoModel(backend=backend).sharded(m)


def test_halo_validation_errors():
    """Shard heights under the halo are refused as the reference refuses
    them."""
    left, right = int_pair(h=32)
    census = dict(num_disparities=16, window=9, cost="census")
    sad = dict(num_disparities=16, window=5, cost="sad")  # halo 3, rounded to 8 for K1
    for ref_fn, fn, cfg in ((ref_sharded.match_pair_sharded, sharded.match_pair_sharded,
                             census),
                            (ref_sharded.match_pair_sharded_pallas,
                             sharded.match_pair_sharded_pallas, sad)):
        with pytest.raises(ValueError):
            ref_fn(left, right, RefMatchConfig(**cfg), _ref_mesh(8))
        with pytest.raises(ValueError, match="tile height 4"):
            fn(left, right, MatchConfig(**cfg), cpu_mesh(8))
    with pytest.raises(ValueError, match="halo\\+warmup"):
        sgm_sharded.match_pair_sgm_sharded(left, right, MatchConfig(**sad), SGMConfig(),
                                           cpu_mesh(2), exact=False, warmup=16)

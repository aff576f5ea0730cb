"""The port's parity pipeline (``stepth_tpu_torch.match.parity``) against the
JAX package's ``match.parity`` and the NumPy oracle, bit for bit, on the
shapes and cases of ``tests/test_match_parity.py``."""

import numpy as np
import pytest
import torch

from stepth_tpu.match import parity as ref_parity
from stepth_tpu.models import StereoModel as RefStereoModel
from stepth_tpu.oracle import pipeline as oracle_pipe
from stepth_tpu.oracle import subdivision as oracle_sub
from stepth_tpu_torch.match import parity
from stepth_tpu_torch.models import StereoModel

from tests.torch_port import cuda, np_, one_torch_thread  # noqa: F401 (fixtures)


def _pair(rng, h=40, w=56, shift=3):
    """tests/test_match_parity.py's pair: a 4×4-block random field, shifted."""
    base = rng.integers(0, 256, size=(h // 4, w // 4, 3)).astype(np.float32)
    up = np.kron(base, np.ones((4, 4, 1), np.float32))[:h, :w]
    main = up.astype(np.uint8)
    return main, np.roll(main, shift, axis=1)


def _far_pair():
    """An 8×8 uniform main image (leaf seeds at columns and rows 2 and 4)
    and a 200×200 additional image whose only match lies 185 rows and
    columns from the first seed: every leaf is found by phase B, dozens of
    rings out, and the distances (258-261) wrap to u8 (quirk Q2)."""
    main = np.full((8, 8, 3), 7, np.uint8)
    add = np.full((200, 200, 3), 200, np.uint8)
    add[187, 187] = 7
    return main, add


def test_static_geometry_is_the_oracles():
    for n, k in ((37, 0), (37, 3), (53, 6), (1080, 10), (1920, 11), (5, 63), (5, 70)):
        np.testing.assert_array_equal(parity.axis_boundaries(n, k),
                                      oracle_sub.axis_boundaries(n, k))
    for d in range(0, 12):
        for wf in (True, False):
            assert parity.split_axes(d, wf) == oracle_sub.split_axes(d, wf)
            for got, want in zip(parity.level_geometry(37, 53, d, wf),
                                 oracle_sub.level_geometry(37, 53, d, wf)):
                np.testing.assert_array_equal(got, want)
    assert parity.default_max_splits(400, 600) == oracle_sub.default_max_splits(400, 600)


@pytest.mark.parametrize("min_s,max_s", [(4, 8), (2, 10), (6, 6)])
def test_subdivision_matches_reference(rng, min_s, max_s):
    img = rng.integers(0, 256, size=(37, 53, 3), dtype=np.uint8)
    prec = np.array([30, 30, 30], np.int32)
    got = parity.subdivide(img, prec, min_splits=min_s, max_splits=max_s, device="cpu")
    want = ref_parity.subdivide(img, prec, min_splits=min_s, max_splits=max_s)
    exp = oracle_sub.subdivide(img, prec, min_splits=min_s, max_splits=max_s)
    for name in ("level", "value", "seed_x", "seed_y"):
        np.testing.assert_array_equal(np_(getattr(got, name)), np_(getattr(want, name)))
        np.testing.assert_array_equal(np_(getattr(got, name)),
                                      getattr(exp, name).astype(np.int32))


@pytest.mark.parametrize("phase_a", [2, 6, 30])
def test_match_distance_matches_reference(rng, phase_a):
    main, add = _pair(rng)
    prec = (20, 20, 20)
    leaf = parity.subdivide(main, prec, min_splits=4, max_splits=9, device="cpu")
    stats = {}
    got = np_(parity.match_distance(leaf, add, prec, max_radius=30, phase_a_radius=phase_a,
                                    stats=stats))
    raw = oracle_pipe.raw_disparity_map(main, add, prec, min_splits=4, max_splits=9,
                                        max_radius=30)
    np.testing.assert_array_equal(got, raw)
    ref_leaf = ref_parity.subdivide(main, np.asarray(prec, np.int32), min_splits=4, max_splits=9)
    want = ref_parity.match_distance(ref_leaf, add, np.asarray(prec, np.int32), max_radius=30,
                                     phase_a_radius=phase_a)
    np.testing.assert_array_equal(got, np_(want))
    assert 0.0 < stats["matched_share"] <= 1.0 and stats["leaves"] > 0


def test_full_pipeline_bit_parity(rng):
    main, add = _pair(rng, 48, 64, shift=4)
    prec = (25, 25, 25)
    kw = dict(min_splits=4, max_splits=10, max_radius=40)
    got = np_(parity.depth_from_additional(main, add, prec, phase_a_radius=8, device="cpu",
                                           **kw))
    want = ref_parity.depth_from_additional(main, add, np.asarray(prec, np.int32),
                                            phase_a_radius=8, **kw)
    np.testing.assert_array_equal(got, np_(want))
    np.testing.assert_array_equal(got, oracle_pipe.depth_from_additional_oracle(
        main, add, prec, **kw))
    assert got.dtype == np.uint8 and got.any()


def test_no_match_defined_zero():
    main = np.zeros((16, 16, 3), np.uint8)
    add = np.full((16, 16, 3), 255, np.uint8)
    got = np_(parity.depth_from_additional(main, add, (1, 1, 1), min_splits=2, max_splits=6,
                                           max_radius=20, device="cpu"))
    assert (got == 0).all()  # quirk Q3 guarded
    want = ref_parity.depth_from_additional(main, add, np.asarray([1, 1, 1], np.int32),
                                            min_splits=2, max_splits=6, max_radius=20)
    np.testing.assert_array_equal(got, np_(want))


def test_far_match_wraps_over_many_phase_b_rings():
    main, add = _far_pair()
    prec = (5, 5, 5)
    leaf = parity.subdivide(main, prec, min_splits=2, max_splits=2, device="cpu")
    stats = {}
    got = np_(parity.match_distance(leaf, add, prec, stats=stats))
    raw = oracle_pipe.raw_disparity_map(main, add, prec, min_splits=2, max_splits=2)
    np.testing.assert_array_equal(got, raw)
    assert sorted(np.unique(got)) == [2, 4, 5]  # 258, 260, 261 wrapped
    assert stats["rings"] > 100 and stats["matched_share"] == 1.0
    ref_leaf = ref_parity.subdivide(main, np.asarray(prec, np.int32), min_splits=2,
                                    max_splits=2)
    want = ref_parity.match_distance(ref_leaf, add, np.asarray(prec, np.int32))
    np.testing.assert_array_equal(got, np_(want))


def test_phase_b_chunks_and_unreachable_leaves(rng, monkeypatch):
    """A gather budget of a few leaves splits every ring into chunks; leaves
    no ring can reach stop the sweep; the result stays the oracle's."""
    monkeypatch.setattr(parity, "_GATHER_BYTES", 24 * 64 * 3)
    main, add = _pair(rng, 24, 32, shift=2)
    add = add.copy()
    add[:, :, 0] = 255 - add[:, :, 0]  # most leaves never match
    prec = (40, 40, 40)
    stats = {}
    got = np_(parity.match_distance(parity.subdivide(main, prec, 3, 6, device="cpu"), add,
                                    prec, max_radius=60, phase_a_radius=3, stats=stats))
    raw = oracle_pipe.raw_disparity_map(main, add, prec, min_splits=3, max_splits=6,
                                        max_radius=60)
    np.testing.assert_array_equal(got, raw)
    assert stats["matched_share"] < 1.0 and stats["rings"] < 60


def test_model_parity_backend_matches_reference(rng):
    main, add = _pair(rng, 48, 64, shift=4)
    ref = RefStereoModel(backend="parity", precision=(30, 30, 30))
    model = StereoModel(backend="parity", precision=(30, 30, 30))
    want = ref(main, add)
    got = model(torch.from_numpy(main), torch.from_numpy(add))
    np.testing.assert_array_equal(np_(got.disparity), np_(want.disparity))
    np.testing.assert_array_equal(np_(got.valid), np_(want.valid))
    np.testing.assert_array_equal(np_(got.cost), np_(want.cost))
    du8 = model.depth_u8(main, add, device="cpu")
    assert du8.dtype == torch.uint8
    np.testing.assert_array_equal(np_(du8), np_(ref.depth_u8(main, add)))
    with pytest.raises(NotImplementedError, match="parity"):
        model.batched()


@pytest.mark.cuda
def test_parity_on_card_equals_cpu(cuda, rng):
    main, add = _pair(rng, 96, 128, shift=5)
    noisy = np.clip(add.astype(int) + rng.integers(-3, 4, add.shape), 0, 255).astype(np.uint8)
    for a in (add, noisy):
        want = parity.depth_from_additional(main, a, (36,) * 3, device="cpu")
        got = parity.depth_from_additional(main, a, (36,) * 3, device=cuda)
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)
    main, add = _far_pair()
    leaf = parity.subdivide(main, (5, 5, 5), 2, 2, device=cuda)
    got = parity.match_distance(leaf, add, (5, 5, 5))
    want = parity.match_distance(parity.subdivide(main, (5, 5, 5), 2, 2, device="cpu"), add,
                                 (5, 5, 5))
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)

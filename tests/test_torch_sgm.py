"""``match/sgm.py``, the plain-torch SGM (the ``sgm`` backend), vs the JAX
package's XLA backend (``stepth_tpu/match/sgm.py``).

Rules: the recurrence and the direction sums are the same f32 ops in the
same order as the reference's, so ``dir_step`` and ``aggregate`` are held
exactly equal on random volumes, integer-valued and float alike. The full
matcher adds box sums, which the two packages take by cumulative sums in
another order: exact on integer-valued gray inputs (every partial sum is an
integer below 2²⁴), the reference's "close" rule on float textures."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stepth_tpu.config import MatchConfig as RefMatchConfig
from stepth_tpu.match import sgm as ref_sgm
from stepth_tpu.models.stereo import StereoModel as RefStereoModel
from stepth_tpu_torch.config import MatchConfig, SGMConfig, from_dict
from stepth_tpu_torch.match import sgm
from stepth_tpu_torch.models.stereo import StereoModel

from tests.test_match_dense import make_pair
from tests.torch_port import assert_close, np_, one_torch_thread  # noqa: F401 (autouse fixture)


def _volume(rng, kind, shape):
    if kind == "int":
        return rng.integers(0, 400, shape).astype(np.float32)
    return rng.uniform(0, 400, shape).astype(np.float32)


def _int_pair(rng, h=40, w=72, shift=5):
    left = rng.integers(0, 256, (h, w)).astype(np.float32)
    return left, np.roll(left, -shift, axis=1)


def _equal(want, got):
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np_(b), np_(a))


@pytest.mark.parametrize("kind", ["int", "float"])
@pytest.mark.parametrize("shift", [0, 1, -1])
def test_dir_step_exact(rng, shift, kind):
    carry = _volume(rng, kind, (37, 16))
    c = _volume(rng, kind, (37, 16))
    want = ref_sgm.dir_step(jnp.asarray(carry), jnp.asarray(c), shift, jnp.float32(25.0),
                            jnp.float32(100.0))
    got = sgm.dir_step(torch.from_numpy(carry), torch.from_numpy(c), shift, 25.0, 100.0)
    np.testing.assert_array_equal(np_(got), np_(want))


@pytest.mark.parametrize("kind", ["int", "float"])
@pytest.mark.parametrize("directions", [2, 4, 8])
def test_aggregate_exact(rng, directions, kind):
    """All directions summed in the reference's order: bit-equal on a float
    volume too."""
    vol = _volume(rng, kind, (23, 37, 16))
    want = ref_sgm.aggregate(jnp.asarray(vol), ref_sgm.SGMConfig(directions=directions),
                             200.0, 800.0)
    got = sgm.aggregate(torch.from_numpy(vol), SGMConfig(directions=directions), 200.0, 800.0)
    np.testing.assert_array_equal(np_(got), np_(want))


def test_scan_dir_from_returns_final_carry(rng):
    vol = _volume(rng, "float", (9, 11, 8))
    carry0 = _volume(rng, "float", (11, 8))
    want = ref_sgm.scan_dir_from(jnp.asarray(vol), jnp.asarray(carry0), reverse=True,
                                 shift=1, p1=jnp.float32(4.0), p2=jnp.float32(9.0))
    got = sgm.scan_dir_from(torch.from_numpy(vol), torch.from_numpy(carry0), reverse=True,
                            shift=1, p1=4.0, p2=9.0)
    _equal(want, got)


@pytest.mark.parametrize(
    "cost, window, directions",
    [("sad", 5, 4), ("census", 5, 4), ("ssd", 5, 2), ("sad", 9, 8)],
)
def test_match_pair_sgm_exact(rng, cost, window, directions):
    """Integer-valued gray inputs: disparity, valid and cost exact."""
    left, right = _int_pair(rng)
    cfg = dict(num_disparities=16, window=window, cost=cost, census_window=5,
               lr_threshold=1.0)
    sgm_cfg = dict(directions=directions, **(dict(p1=2.0, p2=8.0) if cost == "census" else {}))
    want = ref_sgm.match_pair_sgm(left, right, RefMatchConfig(**cfg),
                                  ref_sgm.SGMConfig(**sgm_cfg))
    got = sgm.match_pair_sgm(left, right, MatchConfig(**cfg), SGMConfig(**sgm_cfg),
                             device="cpu")
    _equal(want, got)
    assert 0.5 < np_(got.valid).mean() < 1  # the LR check flags the wrapped band


def test_match_pair_sgm_float_texture_close(rng):
    """Float textures: the cumulative box sums round differently in the two
    packages, so the reference's "close" rule (the f32 sums can move a
    winner at an exact tie)."""
    left, right = make_pair(rng, h=48, w=96, shift=6)
    cfg = dict(num_disparities=16, window=5, lr_threshold=1.0, uniqueness=0.05)
    want = ref_sgm.match_pair_sgm(left, right, RefMatchConfig(**cfg))
    got = sgm.match_pair_sgm(torch.from_numpy(left), torch.from_numpy(right),
                             MatchConfig(**cfg))
    assert_close(np_(want.disparity), np_(want.valid), np_(got.disparity), np_(got.valid))
    assert abs(float(np.median(np_(got.disparity)[8:-8, 24:-8])) - 6) <= 0.5


def test_sgm_backend_matches_reference(rng):
    """``StereoModel(backend="sgm")``, configured from the reference's
    model: exact on integer-valued inputs, ``depth_u8`` included."""
    left, right = _int_pair(rng, h=32, w=64, shift=4)
    ref = RefStereoModel(backend="sgm", match=RefMatchConfig(num_disparities=16, window=5),
                         sgm=ref_sgm.SGMConfig(directions=4))
    model = from_dict(StereoModel, dataclasses.asdict(ref))
    assert model.sgm == SGMConfig(directions=4)
    _equal(ref(left, right), model(left, right, device="cpu"))
    np.testing.assert_array_equal(
        np_(model.depth_u8(torch.from_numpy(left), torch.from_numpy(right))),
        np_(ref.depth_u8(left, right)))


def test_bad_directions_raise():
    vol = torch.zeros((4, 5, 8))
    with pytest.raises(ValueError, match="directions"):
        sgm.aggregate(vol, SGMConfig(directions=3), 1.0, 2.0)
    assert sgm.SGMConfig is SGMConfig  # re-exported where the reference keeps it

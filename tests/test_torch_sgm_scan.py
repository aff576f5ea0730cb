"""K7, one SGM direction: its plain version vs the Pallas ``_scan_kernel``
(``stepth_tpu/match/pallas_sgm.py``, interpret mode), for the scans along
rows (forward and reverse, shift 0 and ±1: ↓y, ↑y and the four diagonals)
and along columns, as the first direction and onto an accumulator, in f32
and bf16. The card test of K7 is in ``test_torch_fused_sgm.py``.

Rule: exact equality on the real region. The volumes are integer-valued,
so every path cost and sum is an exact f32 integer; the recurrence is the
same ops in the same order, and bf16 rounds each stored sum once, as the
reference does. The reference's padded rows and lanes never reach the real
region."""

import jax.numpy as jnp
import numpy as np
import pytest

from stepth_tpu.match import pallas_sgm
from stepth_tpu.match.sgm import SGMConfig
from stepth_tpu_torch.match import fused_sgm

from tests.test_torch_fused_sgm import DTYPES, S, S_REAL, T, T_REAL, _equal, _torch
from tests.torch_port import one_torch_thread  # noqa: F401 (autouse fixture)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("first", [True, False], ids=["first", "acc"])
@pytest.mark.parametrize("shift", [0, 1, -1])
@pytest.mark.parametrize("reverse", [False, True])
def test_scan_plain_matches_pallas(rng, reverse, shift, first, dtype):
    """K7 along the rows of [D, H, W] (the vertical directions and the
    diagonals): ``acc + L`` in the volume's type, updated in place."""
    vol = rng.integers(0, 300, (16, S, T)).astype(np.float32)
    acc = rng.integers(0, 3000, (16, S, T)).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    want = pallas_sgm._scan_direction(
        jnp.asarray(vol, jdt), None if first else jnp.asarray(acc, jdt), S_real=S_REAL,
        T_real=T_REAL, p1=100.0, p2=400.0, reverse=reverse, shift=shift, interpret=True)
    t_acc = None if first else _torch(acc[:, :S_REAL, :T_REAL], tdt)
    got = fused_sgm.scan_direction(_torch(vol[:, :S_REAL, :T_REAL], tdt), t_acc, 100.0, 400.0,
                                   axis=1, reverse=reverse, shift=shift)
    assert got.dtype == tdt
    if not first:
        assert got is t_acc
    _equal([np.asarray(want[:, :S_REAL, :T_REAL].astype(jnp.float32))], [got])


@pytest.mark.parametrize("reverse", [False, True])
def test_scan_along_columns_matches_pallas_on_transpose(rng, reverse):
    """K7 along the columns (→x, ←x) needs no transposed volume: it equals
    the reference's scan of the transpose."""
    vol = rng.integers(0, 300, (16, S, T)).astype(np.float32)  # [D, W, H] for the reference
    acc = rng.integers(0, 3000, (16, S, T)).astype(np.float32)
    want = pallas_sgm._scan_direction(jnp.asarray(vol), jnp.asarray(acc), S_real=S_REAL,
                                      T_real=T_REAL, p1=100.0, p2=400.0, reverse=reverse,
                                      interpret=True)
    real = (slice(None), slice(0, S_REAL), slice(0, T_REAL))
    got = fused_sgm.scan_direction(_torch(vol[real].transpose(0, 2, 1)),
                                   _torch(acc[real].transpose(0, 2, 1)), 100.0, 400.0,
                                   axis=2, reverse=reverse)
    _equal([np.asarray(want[real]).transpose(0, 2, 1)], [got])


@pytest.mark.parametrize("directions", [2, 8])
def test_aggregate_plain_matches_pallas(rng, directions):
    """All directions summed in place in the reference's order
    (``aggregate_pallas``, whose horizontal pair runs on the transpose; it
    takes both axes padded to multiples of 128, as its ``_aggregated_volume``
    pads them)."""
    vol = rng.integers(0, 300, (8, 128, T)).astype(np.float32)
    want = pallas_sgm.aggregate_pallas(jnp.asarray(vol), SGMConfig(directions=directions),
                                       100.0, 400.0, S_dims=(S_REAL, T_REAL), interpret=True)
    got = fused_sgm.aggregate_fused(_torch(vol[:, :S_REAL, :T_REAL]),
                                    SGMConfig(directions=directions), 100.0, 400.0)
    _equal([np.asarray(want[:, :S_REAL, :T_REAL])], [got])

"""K10, the seeded SGM scan of the sharded relay: its plain version
(``fused_sgm.scan_direction_carry_plain``) against the Pallas
``scan_direction_carry`` (``stepth_tpu/match/pallas_sgm.py:398-521``,
interpret mode), a split scan relayed through it against the continuous
scan, and (on a card) the CUDA kernel against its plain version.

Rule: exact equality. Volumes, accumulators and carries are integer-valued,
so every path cost and sum is an exact f32 integer; the recurrence is the
same ops in the same order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stepth_tpu.match import pallas_sgm
from stepth_tpu_torch.match import fused_sgm

from tests.torch_port import cuda, np_, one_torch_thread  # noqa: F401 (fixtures)

D, S, T = 8, 24, 128
P1, P2 = 4.0, 16.0
DIRECTIONS = [(False, 0), (True, 0), (False, 1), (False, -1), (True, 1), (True, -1)]


def _inputs(rng, d=D, s=S, t=T):
    vol = rng.integers(0, 50, (d, s, t)).astype(np.float32)
    acc = rng.integers(0, 500, (d, s, t)).astype(np.float32)
    carry0 = rng.integers(0, 200, (d, t)).astype(np.float32)
    return vol, acc, carry0


@pytest.mark.parametrize("reverse, shift", DIRECTIONS)
def test_carry_plain_matches_pallas(rng, reverse, shift):
    """Output and final carry, seeded from a nonzero carry onto an
    accumulator."""
    vol, acc, carry0 = _inputs(rng)
    want, want_c = pallas_sgm.scan_direction_carry(
        jnp.asarray(vol), jnp.asarray(acc), jnp.asarray(carry0), S_real=S, T_real=T, p1=P1,
        p2=P2, reverse=reverse, shift=shift, interpret=True)
    t_acc = torch.from_numpy(acc.copy())
    got, got_c = fused_sgm.scan_direction_carry(torch.from_numpy(vol), t_acc,
                                                torch.from_numpy(carry0), P1, P2,
                                                reverse=reverse, shift=shift)
    assert got is t_acc and got_c.shape == (D, T) and got_c.dtype == torch.float32
    np.testing.assert_array_equal(np_(got), np.asarray(want))
    np.testing.assert_array_equal(np_(got_c), np.asarray(want_c))


def _relayed(scan_carry, vol, acc, cuts, reverse, shift):
    """``acc + L`` of one direction over ``vol`` [D, H, W] split at the rows
    ``cuts``, one seeded scan per shard in owner order; returns the sum and
    the last shard's final carry."""
    bounds = list(zip([0] + cuts, cuts + [vol.shape[1]]))
    outs = [None] * len(bounds)
    carry = None
    for i in (reversed(range(len(bounds))) if reverse else range(len(bounds))):
        a, b = bounds[i]
        outs[i], carry = scan_carry(vol[:, a:b].contiguous(), acc[:, a:b].contiguous(), carry,
                                    P1, P2, reverse=reverse, shift=shift)
    return torch.cat(outs, 1), carry


@pytest.mark.parametrize("reverse, shift", DIRECTIONS)
def test_split_scan_equals_continuous(rng, reverse, shift):
    """Three shards of 8, 16 and 16 rows relayed through the plain K10 equal
    one continuous plain K7 scan bit for bit, and the last carry equals the
    continuous scan's; an unseeded K10 is K7."""
    vol, acc, _ = _inputs(rng, s=40, t=56)
    vol, acc = torch.from_numpy(vol), torch.from_numpy(acc)
    want = fused_sgm.scan_direction_plain(vol, acc.clone(), P1, P2, axis=1, reverse=reverse,
                                          shift=shift)
    _, want_c = fused_sgm.scan_direction_carry_plain(vol, None, None, P1, P2,
                                                     reverse=reverse, shift=shift)
    got, got_c = _relayed(fused_sgm.scan_direction_carry_plain, vol, acc, [8, 24], reverse,
                          shift)
    assert torch.equal(got, want) and torch.equal(got_c, want_c)
    unseeded, _ = fused_sgm.scan_direction_carry_plain(vol, None, None, P1, P2,
                                                       reverse=reverse, shift=shift)
    assert torch.equal(unseeded, fused_sgm.scan_direction_plain(vol, None, P1, P2, axis=1,
                                                                reverse=reverse, shift=shift))


def test_carry_scan_rejects_a_bad_shift(rng):
    vol, acc, carry0 = (torch.from_numpy(a) for a in _inputs(rng, s=8, t=16))
    with pytest.raises(ValueError, match="shift"):
        fused_sgm.scan_direction_carry(vol, acc, carry0, P1, P2, reverse=False, shift=2)


# ---- on a card ------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("cuts", [[24, 48], [13, 41]], ids=["24-48", "13-41"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D_", [24, 144])
def test_kernel_matches_plain_on_card(cuda, D_, dtype, cuts):
    """K10 bit-equal to its plain version from a nonzero carry in all six
    relayed directions at an unaligned size, and a split scan relayed
    through K10 equal to one continuous K7 scan (output and carry); the
    cuts 13 and 41 make shards of 13, 28 and 29 rows, none a whole number
    of the kernel's stages."""
    rng = np.random.default_rng(3)
    vol, acc, carry0 = (torch.from_numpy(a).to(cuda) for a in _inputs(rng, D_, 70, 300))
    vol, acc = vol.to(dtype), acc.to(dtype)
    for reverse, shift in DIRECTIONS:
        kw = dict(reverse=reverse, shift=shift)
        got = fused_sgm.scan_direction_carry(vol, acc.clone(), carry0, P1, P2, **kw)
        want = fused_sgm.scan_direction_carry_plain(vol, acc.clone(), carry0, P1, P2, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), kw
        cont = fused_sgm.scan_direction(vol, acc.clone(), P1, P2, axis=1, **kw)
        _, cont_c = fused_sgm.scan_direction_carry(vol, None, None, P1, P2, **kw)
        split, split_c = _relayed(fused_sgm.scan_direction_carry, vol, acc, cuts, reverse,
                                  shift)
        torch.cuda.synchronize()
        assert torch.equal(split, cont) and torch.equal(split_c, cont_c), kw

"""K6–K9, the SGM kernels: their plain versions vs the Pallas kernels of
``stepth_tpu/match/pallas_sgm.py`` (interpret mode), and (on a card) each
CUDA kernel vs its plain version.

Rule: exact equality of every output on the real region. The inputs are
integer-valued (gray images from ``rng.integers``, integer volumes), so every
cost, box sum, path cost and sum of directions is an exact f32 integer and
the order of adds cannot matter; the recurrence, the WTA and the bf16
roundings are the same ops in the same places. The Pallas kernels work on
padded volumes; their padding never reaches the real region."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke

from stepth_tpu.config import MatchConfig as RefMatchConfig
from stepth_tpu.match import pallas_sgm
from stepth_tpu_torch.config import MatchConfig
from stepth_tpu_torch.match import fused_sgm
from stepth_tpu_torch.utils import tracing

from tests.torch_port import cuda, np_, one_torch_thread  # noqa: F401 (fixtures)

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _int_pair(rng, h=40, w=72, shift=5):
    left = rng.integers(0, 256, (h, w)).astype(np.float32)
    return left, np.roll(left, -shift, axis=1)


def _equal(want, got):
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np_(b.float() if isinstance(b, torch.Tensor) else b),
                                      np.asarray(a, np.float32))


def _torch(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize(
    "cost, window, census_window",
    [("sad", 9, 7), ("ssd", 5, 7), ("census", 5, 5), ("census", 9, 7)],
)
def test_volume_plain_matches_pallas(rng, cost, window, census_window, dtype):
    """K6: the box-aggregated volume [D, H, W], f32 or rounded once to bf16."""
    left, right = _int_pair(rng)
    cfg = dict(num_disparities=16, window=window, cost=cost, census_window=census_window)
    jdt, tdt = DTYPES[dtype]
    want, _ = pallas_sgm._aggregated_volume(jnp.asarray(left), jnp.asarray(right),
                                            RefMatchConfig(**cfg), 16, True, dtype=jdt)
    got = fused_sgm.aggregated_volume(_torch(left), _torch(right), MatchConfig(**cfg), tdt)
    assert got.shape == (16, 40, 72) and got.dtype == tdt
    _equal([np.asarray(want[:, :40, :72].astype(jnp.float32))], [got])


def test_volume_row_window_matches_pallas(rng):
    """K6 on a halo-extended row shard: rows outside [0, g_h) cost nothing."""
    left, right = _int_pair(rng)
    cfg = dict(num_disparities=8, window=5)
    want, _ = pallas_sgm._aggregated_volume(jnp.asarray(left), jnp.asarray(right),
                                            RefMatchConfig(**cfg), 16, True, g_row0=-4, g_h=30)
    got = fused_sgm.aggregated_volume(_torch(left), _torch(right), MatchConfig(**cfg),
                                      g_row0=-4, g_h=30)
    _equal([want[:, :40, :72]], [got])


# K6's edge cases (h, w, D, window, cost, census_window, g_row0, g_h): D = 1,
# w below D, windows 1 and 11 (census with 3 planes), a halo-extended shard
VOLUME_EDGES = [
    (20, 72, 1, 5, "sad", 7, 0, None),
    (20, 12, 16, 7, "ssd", 7, 0, None),
    (20, 72, 8, 1, "sad", 7, 0, None),
    (20, 72, 8, 11, "census", 9, 0, None),
    (24, 72, 8, 7, "census", 9, -5, 15),
]


@pytest.mark.parametrize("h, w, D, window, cost, census_window, g_row0, g_h", VOLUME_EDGES)
def test_volume_edges_match_pallas(rng, h, w, D, window, cost, census_window, g_row0, g_h):
    """K6 at the shapes its tiling must keep: exact on integer images."""
    left, right = _int_pair(rng, h, w, 3)
    cfg = dict(num_disparities=D, window=window, cost=cost, census_window=census_window)
    want, _ = pallas_sgm._aggregated_volume(jnp.asarray(left), jnp.asarray(right),
                                            RefMatchConfig(**cfg), 16, True, g_row0=g_row0,
                                            g_h=g_h)
    got = fused_sgm.aggregated_volume(_torch(left), _torch(right), MatchConfig(**cfg),
                                      g_row0=g_row0, g_h=g_h)
    assert got.shape == (D, h, w)
    _equal([want[:, :h, :w]], [got])


S, T, S_REAL, T_REAL = 48, 256, 41, 247


@pytest.mark.parametrize("lr_threshold", [None, 1.0])
@pytest.mark.parametrize("uniqueness", [None, 0.1])
def test_wta_plain_matches_pallas(rng, uniqueness, lr_threshold):
    """K9 (+ K4 for the LR check): all four outputs."""
    vol = rng.integers(0, 50, (16, S, T)).astype(np.float32)
    cfg = dict(num_disparities=16, uniqueness=uniqueness, lr_threshold=lr_threshold)
    want = pallas_sgm._wta_from_volume(jnp.asarray(vol), Wr=T_REAL, cfg=RefMatchConfig(**cfg),
                                       interpret=True)
    got = fused_sgm.wta_from_volume(_torch(vol[:, :S_REAL, :T_REAL]), MatchConfig(**cfg))
    _equal([w[:S_REAL, :T_REAL] for w in want], got)
    if uniqueness is not None:
        assert 0 < np_(got[3]).mean() < 1


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("uniqueness", [None, 0.1])
def test_scan_wta_plain_matches_pallas(rng, uniqueness, dtype):
    """K8: the final ↑y scan with the WTA fused in. 300 real columns of 384
    with ``lane_tile=128``, so the reference relays the right view across
    two lane-tile boundaries."""
    vol = rng.integers(0, 50, (16, S, 384)).astype(np.float32)
    acc = rng.integers(0, 500, (16, S, 384)).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    cfg = dict(num_disparities=16, uniqueness=uniqueness)
    want = pallas_sgm._scan_wta_direction(
        jnp.asarray(vol, jdt), jnp.asarray(acc, jdt), S_real=S_REAL, T_real=300, p1=20.0,
        p2=80.0, cfg=RefMatchConfig(**cfg), interpret=True, lane_tile=128)
    real = (slice(None), slice(0, S_REAL), slice(0, 300))
    got = fused_sgm.scan_wta_direction(_torch(vol[real], tdt), _torch(acc[real], tdt), 20.0,
                                       80.0, MatchConfig(**cfg))
    _equal([w[:S_REAL, :300] for w in want], got)


def test_directions_order_and_checks():
    assert fused_sgm.directions(4) == ((2, False, 0), (2, True, 0), (1, False, 0),
                                       (1, True, 0))
    assert fused_sgm.directions(8)[2:6] == ((1, False, 1), (1, False, -1), (1, True, 1),
                                            (1, True, -1))
    with pytest.raises(ValueError, match="directions"):
        fused_sgm.directions(6)
    with pytest.raises(ValueError, match="axis"):
        fused_sgm._step(0, False, 0)


# ---- K7's ring: the rules the wrapper applies --------------------------------


@pytest.mark.parametrize("D, h, w, dy, dx, dtype, offset, want", [
    (256, 1080, 1920, 1, 1, torch.float32, 0, True),  # the 1080p D=256 diagonals: 121 blocks
    (256, 1080, 1920, -1, 0, torch.float32, 0, True),  # and verticals: 120
    (256, 1080, 1920, 0, 1, torch.float32, 0, False),  # →x, ←x: chains along the rows
    (128, 375, 1242, 1, 0, torch.float32, 0, False),  # KITTI: D = 128
    (128, 1080, 1920, -1, 0, torch.float32, 0, False),  # D = 128 on a 16-byte pitch
    (129, 1080, 1920, -1, 1, torch.float32, 0, True),
    (200, 375, 1242, 1, 0, torch.float32, 0, False),  # 4,968-byte rows
    (200, 375, 1240, 1, -1, torch.bfloat16, 0, True),  # 2,480-byte rows
    (200, 375, 1244, 1, 0, torch.bfloat16, 0, False),  # 2,488
    (256, 9, 4, 1, 1, torch.float32, 0, True),  # one 16-byte chunk a row
    (257, 1080, 1920, 1, 0, torch.float32, 0, False),  # past the ring's limit
    (256, 1080, 1920, 1, 0, torch.float32, 8, False),  # a tensor 8 bytes into its storage
    (256, 1, 2112, 1, 0, torch.float32, 0, True),  # 132 bands: a block an SM
    (256, 1, 2128, 1, 0, torch.float32, 0, False),  # 133: the staged kernel
    (256, 1, 4240, 1, 1, torch.float32, 0, False),
    (256, 1080, 5120, 1, 1, torch.float32, 0, False),  # 321 blocks
    (256, 1080, 5120, -1, 0, torch.bfloat16, 0, False),  # 320
    (200, 1080, 8192, 1, -1, torch.float32, 0, False),  # 513
    (256, 2160, 3840, -1, 1, torch.bfloat16, 0, False),  # 4K: 241
])
def test_ring_rule(D, h, w, dy, dx, dtype, offset, want):
    """Which K7 launches take the ring on a card of 132 SMs: scans over
    rows at 128 < D <= 256, rows and pointers of 16-byte multiples, and a
    schedule of no more blocks than SMs."""
    assert fused_sgm.takes_ring(D, h, w, dy, dx, dtype, 132, 1 << 20,
                                (1 << 20) + offset) is want


def test_ring_band_is_the_kernels():
    """The wrapper's bands are the ring kernel's (``kRingBand``), which the
    launcher no longer takes as an argument."""
    src = (fused_sgm.kernels.CSRC_DIR / "fused_sgm.cu").read_text()
    assert f"constexpr int kRingBand = {fused_sgm.RING_BAND};" in src


def test_scan_launches_choose_ring_or_staged(monkeypatch):
    """What each K7 and K10 launch is given, on meta tensors standing for
    the card's: at 1080×1920 D=256 the six scans over rows take the ring
    (a schedule and its blocks) and the two along rows the staged kernel;
    KITTI's D=128, rows past one block an SM and K10's relay never take
    it. ``sgm.scan_ring`` and ``sgm.scan_staged`` count them."""
    calls = []
    monkeypatch.setattr(fused_sgm, "_sm_count", lambda device: 132)
    monkeypatch.setattr(fused_sgm.kernels, "check_cuda_tensor", lambda *a: None)
    monkeypatch.setattr(fused_sgm.K7, "launch", lambda dev, *a: calls.append(("K7", a)))
    monkeypatch.setattr(fused_sgm.K10, "launch", lambda dev, *a: calls.append(("K10", a)))
    for D, h, w, rings in ((256, 1080, 1920, 6), (128, 375, 1242, 0), (256, 1080, 5120, 0)):
        vol = torch.empty((D, h, w), device="meta")
        before = tracing.counters()
        calls.clear()
        for axis, reverse, shift in fused_sgm.directions(8):
            fused_sgm.scan_direction(vol, torch.empty_like(vol), 8.0, 32.0, axis=axis,
                                     reverse=reverse, shift=shift)
        ring = [a[12] > 0 for _, a in calls]  # blocks: 0 for the staged kernel
        assert sum(ring) == rings and len(calls) == 8
        for (_, a), (axis, reverse, shift), r in zip(calls, fused_sgm.directions(8), ring):
            assert r == (axis == 1 and rings > 0)
            assert (a[11] is None) == (a[13] is None) == (not r)  # schedule, scratch
            if r:
                starts, c0s = fused_sgm.ring_schedule(h, w, *fused_sgm._step(axis, reverse,
                                                                              shift))
                assert a[12] == len(starts) - 1
        after = tracing.counters()
        assert after.get("sgm.scan_ring", 0) - before.get("sgm.scan_ring", 0) == rings
        assert after.get("sgm.scan_staged", 0) - before.get("sgm.scan_staged", 0) == 8 - rings
        calls.clear()
        for reverse, shift in ((False, 1), (True, -1), (False, 0)):
            fused_sgm.scan_direction_carry(vol, None, None, 8.0, 32.0, reverse=reverse,
                                           shift=shift)
        assert [k for k, _ in calls] == ["K10"] * 3
        assert tracing.counters().get("sgm.scan_ring", 0) == after.get("sgm.scan_ring", 0)


@pytest.mark.parametrize("h, w", [(1080, 1920), (1920, 1080), (37, 64), (70, 32), (1, 64),
                                  (64, 1), (5, 3)])
@pytest.mark.parametrize("dy, dx", [(1, 1), (1, -1), (-1, 1), (-1, -1), (1, 0), (-1, 0)])
def test_ring_schedule_covers_every_band_once_along_the_wavefront(h, w, dy, dx):
    """The ring's bands hold every chain once, each with the rows where it
    meets the image; the schedule gives each band to one block, a block's
    bands follow one another along the row wavefront without overlapping,
    and there are as many blocks as bands meet one row."""
    band, sl = fused_sgm.RING_BAND, dx * dy
    bands = fused_sgm.ring_bands(h, w, dy, dx)
    chains = np.arange(-(h - 1), w) if sl > 0 else np.arange(w + h - 1) if sl < 0 \
        else np.arange(w)
    held = np.concatenate([np.arange(c0, c0 + band) for c0, _, _ in bands])
    np.testing.assert_array_equal(np.intersect1d(held, chains), chains)
    assert len(np.unique(held)) == len(held)
    y = np.arange(h)
    for c0, start, steps in bands:
        x = np.arange(c0, c0 + band)[:, None] + sl * y[None, :]
        rows = y[((x >= 0) & (x < w)).any(0)]
        assert steps == len(rows) == rows[-1] - rows[0] + 1
        assert start == (rows[0] if dy > 0 else h - 1 - rows[-1])
    starts, c0s = fused_sgm.ring_schedule(h, w, dy, dx)
    assert sorted(c0s) == sorted(c0 for c0, _, _ in bands)
    span = {c0: (start, start + steps) for c0, start, steps in bands}
    for b in range(len(starts) - 1):
        mine = [span[c] for c in c0s[starts[b]:starts[b + 1]]]
        assert mine and all(e <= s for (_, e), (s, _) in zip(mine, mine[1:]))
    meet = max(sum(s <= t < e for s, e in span.values()) for t in range(h))
    assert len(starts) - 1 == meet


# ---- on a card ------------------------------------------------------------


def _card_volume(cuda, cfg, dtype, h=70, w=300):
    rng = np.random.default_rng(5)
    left, right = _int_pair(rng, h, w, 9)
    lg, rg = _torch(left).to(cuda), _torch(right).to(cuda)
    return lg, rg, fused_sgm.aggregated_volume_plain(lg, rg, cfg, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cost, D", [("sad", 24), ("census", 144)])
def test_kernels_match_plain_on_card(cuda, cost, D, dtype):
    """K6, K7 in all eight directions, K8 and K9 (+ K4) bit-equal to their
    plain versions at an unaligned size."""
    cfg = MatchConfig(num_disparities=D, window=5, cost=cost, census_window=5,
                      uniqueness=0.1, lr_threshold=1.0)
    lg, rg, vol = _card_volume(cuda, cfg, dtype)
    got = fused_sgm.aggregated_volume(lg, rg, cfg, dtype)
    torch.cuda.synchronize()
    assert torch.equal(got, vol)
    acc = acc_p = None
    for axis, reverse, shift in fused_sgm.directions(8)[:-1]:
        acc = fused_sgm.scan_direction(vol, acc, 25.0, 100.0, axis=axis, reverse=reverse,
                                       shift=shift)
        acc_p = fused_sgm.scan_direction_plain(vol, acc_p, 25.0, 100.0, axis=axis,
                                               reverse=reverse, shift=shift)
        torch.cuda.synchronize()
        assert torch.equal(acc, acc_p), (axis, reverse, shift)
    for want, got in ((fused_sgm.scan_wta_direction_plain(vol, acc_p, 25.0, 100.0, cfg),
                       fused_sgm.scan_wta_direction(vol, acc_p, 25.0, 100.0, cfg)),
                      (fused_sgm.wta_from_volume_plain(acc_p, cfg),
                       fused_sgm.wta_from_volume(acc_p, cfg))):
        torch.cuda.synchronize()
        for a, b in zip(want, got):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("acc_mode", ["none", "separate", "in_place"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [1, 33, 64, 129, 200, 256])
def test_scan_edges_match_plain_on_card(cuda, D, dtype, acc_mode):
    """K7 bit-equal to its plain version in all eight directions on ragged
    shapes: h and w that are not multiples of the kernel's bands and stages
    (8 or 16 chains, 2-16 steps), smaller than one band, one row, one
    column; and on rows of 16-byte multiples, where the scans over rows at
    D > 128 take the ring (counted on ``sgm.scan_ring``); ``acc`` None, a
    separate tensor, or updated in place (``chip_smoke.K7_EDGE_SHAPES``,
    which ``chip_smoke.check_edges`` repeats on the card)."""
    rng = np.random.default_rng(D)
    for h, w in chip_smoke.K7_EDGE_SHAPES:
        vol = torch.from_numpy(rng.integers(0, 50, (D, h, w)).astype(np.float32)).to(cuda)
        acc0 = torch.from_numpy(rng.integers(0, 500, (D, h, w)).astype(np.float32)).to(cuda)
        vol, acc0 = vol.to(dtype), acc0.to(dtype)
        for axis, reverse, shift in fused_sgm.directions(8):
            kw = dict(axis=axis, reverse=reverse, shift=shift)
            dy, dx = fused_sgm._step(axis, reverse, shift)
            ring = D > 128 and dy != 0 and w * vol.element_size() % 16 == 0
            assert ring == fused_sgm.takes_ring(D, h, w, dy, dx, dtype,
                                                fused_sgm._sm_count(vol.device))
            acc = None if acc_mode == "none" else acc0.clone()
            want = fused_sgm.scan_direction_plain(vol, None if acc is None else acc.clone(),
                                                  25.0, 100.0, **kw)
            before = tracing.counters().get("sgm.scan_ring", 0)
            if acc_mode == "separate":  # out beside acc, which stays as it was
                got = torch.empty_like(vol)
                fused_sgm._launch_k7(vol, acc, got, dy, dx, 25.0, 100.0)
            else:
                got = fused_sgm.scan_direction(vol, acc, 25.0, 100.0, **kw)
            torch.cuda.synchronize()
            assert tracing.counters().get("sgm.scan_ring", 0) - before == int(ring), (h, w, kw)
            assert torch.equal(got, want), (h, w, kw)
            if acc_mode == "separate":
                assert torch.equal(acc, acc0), (h, w, kw)
            if acc_mode == "in_place":
                assert got.data_ptr() == acc.data_ptr()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_rows_match_plain_on_card(cuda, dtype):
    """K7 at D=256 over rows as wide as one block an SM takes (the ring) and
    wider (the staged kernel: the ring's schedule would need more blocks
    than SMs), bit-equal to the plain version and counted on
    ``sgm.scan_ring`` or ``sgm.scan_staged`` (``chip_smoke.K7_WIDE_SHAPES``,
    which ``chip_smoke.check_edges`` repeats on the card)."""
    rng = np.random.default_rng(4240)
    sms = fused_sgm._sm_count(cuda)
    for h, w in chip_smoke.K7_WIDE_SHAPES:
        vol, acc = (torch.from_numpy(rng.integers(0, hi, (256, h, w)).astype(np.float32))
                    .to(cuda).to(dtype) for hi in (50, 500))
        for axis, reverse, shift in fused_sgm.directions(8)[2:]:  # the six over rows
            dy, dx = fused_sgm._step(axis, reverse, shift)
            blocks = len(fused_sgm.ring_schedule(h, w, dy, dx)[0]) - 1
            kw = dict(axis=axis, reverse=reverse, shift=shift)
            want = fused_sgm.scan_direction_plain(vol, acc.clone(), 25.0, 100.0, **kw)
            before = tracing.counters().get("sgm.scan_ring", 0)
            got = fused_sgm.scan_direction(vol, acc.clone(), 25.0, 100.0, **kw)
            torch.cuda.synchronize()
            ring = tracing.counters().get("sgm.scan_ring", 0) - before
            assert ring == int(blocks <= sms), (h, w, kw, blocks)
            assert torch.equal(got, want), (h, w, kw)


@pytest.mark.cuda
@pytest.mark.parametrize("uniqueness", [None, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [1, 16, 33, 64, 128])
def test_scan_wta_edges_match_plain_on_card(cuda, D, dtype, uniqueness):
    """K8 bit-equal to its plain version on every D class of its fused path,
    with h and w below the kernel's band (16 columns) and stage (2-16 rows),
    down to one row and one column (``chip_smoke.K8_EDGES`` repeats these
    cases on the card)."""
    rng = np.random.default_rng(D)
    cfg = MatchConfig(num_disparities=D, window=5, uniqueness=uniqueness)
    for h in (1, 2, 9):
        for w in (1, 17, 300):
            vol, acc = (torch.from_numpy(rng.integers(0, hi, (D, h, w)).astype(np.float32))
                        .to(cuda).to(dtype) for hi in (50, 500))
            want = fused_sgm.scan_wta_direction_plain(vol, acc, 25.0, 100.0, cfg)
            got = fused_sgm.scan_wta_direction(vol, acc, 25.0, 100.0, cfg)
            torch.cuda.synchronize()
            for a, b in zip(want, got):
                assert torch.equal(a, b), (h, w)


@pytest.mark.cuda
def test_scan_wta_rejects_negative_penalties_on_card(cuda):
    cfg = MatchConfig(num_disparities=8, window=5)
    _, _, vol = _card_volume(cuda, cfg, torch.float32, 16, 64)
    with pytest.raises(ValueError, match="p1, p2"):
        fused_sgm.scan_wta_direction(vol, vol.clone(), -1.0, 4.0, cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h, w, D, window, cost, census_window, g_row0, g_h",
                         VOLUME_EDGES + [(40, 300, 200, 17, "sad", 7, 0, None),
                                         (30, 131, 33, 21, "census", 9, -3, 25),
                                         (20, 140, 16, 17, "census", 15, 0, None)])
def test_volume_edges_match_plain_on_card(cuda, h, w, D, window, cost, census_window, g_row0,
                                          g_h, dtype):
    """K6 bit-equal to its plain version at the edge cases, on float images,
    at D = 200, at a window above 17 (the run-time radius) and with 7 census
    planes (tiles too large for shared memory: the images are read from
    global memory)."""
    rng = np.random.default_rng(11)
    left = rng.uniform(0, 255, (h, w)).astype(np.float32)
    right = np.roll(left, -3, axis=1) + rng.uniform(0, 4, (h, w)).astype(np.float32)
    lg, rg = _torch(left).to(cuda), _torch(right).to(cuda)
    cfg = MatchConfig(num_disparities=D, window=window, cost=cost, census_window=census_window)
    got = fused_sgm.aggregated_volume(lg, rg, cfg, dtype, g_row0, g_h)
    want = fused_sgm.aggregated_volume_plain(lg, rg, cfg, dtype, g_row0, g_h)
    torch.cuda.synchronize()
    assert torch.equal(got, want)

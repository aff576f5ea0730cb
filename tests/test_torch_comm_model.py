"""The port's communication model (``stepth_tpu_torch.parallel.comm_model``)
against the JAX package's model and against the port's own transport record.

* (a) at the configurations of ``tests/test_comm_model.py``, the port's
  ``permute`` bytes and op counts equal the JAX model's, except where the
  port moves something else, each difference pinned here: the
  hierarchical paths' final median takes a one-row halo, not ``halo``
  rows; bundle adjustment gathers its partials (the JAX model all-reduces
  them) and sums one scalar per cost, not two;
* (b) on one-process ``["cpu"] * n`` meshes, ``distributed.traffic``
  tallied by each sharded path and by BA equals the model kind by kind,
  bytes, moves and relay hops;
* (c) from shapes alone, the model gives the bytes each rank of the
  two-process drills on the card sent (``PERF.md`` §6, phase 8);
* (d) the projection: the JAX test's sanity checks, and equal to the JAX
  projection on the same exchanges and link rates.
"""

import numpy as np
import pytest

from stepth_tpu.config import MatchConfig as RefMatchConfig
from stepth_tpu.config import PyramidConfig as RefPyramidConfig
from stepth_tpu.parallel import comm_model as ref_cm
from stepth_tpu_torch.config import MatchConfig, PyramidConfig, SGMConfig
from stepth_tpu_torch.fusion import ba
from stepth_tpu_torch.match import fused_refine
from stepth_tpu_torch.parallel import comm_model as cm
from stepth_tpu_torch.parallel import distributed, sgm_pallas_sharded, sgm_sharded, sharded
from stepth_tpu_torch.parallel.mesh import make_mesh

from tests.test_fusion_ba import make_problem
from tests.torch_port import one_torch_thread  # noqa: F401 (autouse fixture)


def _pair(h, w, shift, seed=0):
    """An integer-valued gray pair, the right view shifted by ``shift``."""
    left = np.round(np.random.default_rng(seed).uniform(0, 255, (h, w))).astype(np.float32)
    return left, np.roll(left, -shift, axis=1).astype(np.float32)


# ---- (a) against the JAX model ---------------------------------------------


@pytest.mark.parametrize("ntile", [2, 4])
def test_dense_permute_bytes_equal_reference(ntile):
    want = ref_cm.comm_dense_sharded(RefMatchConfig(num_disparities=16, window=5), 64, 128, ntile)
    got = cm.comm_dense_sharded(MatchConfig(num_disparities=16, window=5), 64, 128, ntile)
    assert got.op_bytes("permute") == want.op_bytes("permute"), got.table()
    assert got.op_counts("permute") == want.op_counts("permute")


@pytest.mark.parametrize("coarse", ["wta", "sgm"])
def test_hierarchical_permute_bytes_differ_by_the_final_median(coarse):
    """The port's final median exchanges one row each way; the reference's
    exchanges ``halo`` rows (``comm_model.py:196-199``) and reads one."""
    kw = dict(num_disparities=32, window=9)
    pkw = dict(levels=3, refine_radius=4, coarsest_disparities=8)
    want = ref_cm.comm_hierarchical_sharded(RefMatchConfig(**kw), RefPyramidConfig(**pkw),
                                            128, 256, 4, tile_rows=8, coarse_backend=coarse)
    got = cm.comm_hierarchical_sharded(MatchConfig(**kw), PyramidConfig(**pkw), 128, 256, 4,
                                       tile_rows=8, coarse_backend=coarse)
    _, halo = sharded._hierarchical_geometry(128, 4, MatchConfig(**kw), PyramidConfig(**pkw), 8)
    assert halo == 8
    assert got.op_bytes("permute") == want.op_bytes("permute") - 2 * 4 * (halo - 1) * 256
    assert got.op_counts("permute") == want.op_counts("permute")
    mine = [c for c in got.collectives if c.kind == "permute"]
    theirs = list(want.collectives)
    assert [c.payload_bytes for c in mine[:-1]] == [c.payload_bytes for c in theirs[:-1]]
    assert (mine[-1].payload_bytes, theirs[-1].payload_bytes) == (4 * 256, 4 * halo * 256)


@pytest.mark.parametrize("exact", [True, False])
def test_sgm_permute_bytes_equal_reference(exact):
    kw = dict(num_disparities=16, window=5, lr_threshold=1.0)
    want = ref_cm.comm_sgm_sharded(RefMatchConfig(**kw), 128, 128, 4, directions=4, exact=exact,
                                   warmup=16)
    got = cm.comm_sgm_sharded(MatchConfig(**kw), 128, 128, 4, directions=4, exact=exact,
                              warmup=16)
    assert got.op_bytes("permute") == want.op_bytes("permute"), got.table()
    assert got.op_counts("permute", serial=True) == want.op_counts("permute", serial=True)


@pytest.mark.parametrize("ntile", [2, 4, 8])
def test_relay_hops_equal_reference(ntile):
    kw = dict(num_disparities=16, window=5, lr_threshold=1.0)
    for directions in (2, 4, 8):
        want = ref_cm.comm_sgm_sharded(RefMatchConfig(**kw), 128, 128, ntile,
                                       directions=directions)
        for pallas in (False, True):
            got = cm.comm_sgm_sharded(MatchConfig(**kw), 128, 128, ntile,
                                      directions=directions, pallas=pallas)
            for serial in (True, False):
                assert (got.op_counts("permute", serial=serial)
                        == want.op_counts("permute", serial=serial))


def test_ba_gathers_against_reference_all_reduces():
    """Per LM iteration the reference all-reduces four cost scalars (two
    costs, each Σr² and Σw); the port gathers one scalar per cost (the
    weight sum once, at the start)."""
    iters, cg = 2, 3
    want = ref_cm.comm_ba_sharded(4, 64, iters, cg)
    got = cm.comm_ba_sharded(4, 64, iters, cg, n=4)
    assert got.op_bytes("gather") == want.op_bytes("allreduce") - 8 * iters
    assert got.op_bytes("permute") == 0
    assert got.op_counts("gather") == iters * (2 * cg + 8) + 2


# ---- (b) against the transport record ----------------------------------------


def _tallied(fn):
    distributed.traffic.reset()
    fn()
    return distributed.traffic.by_kind(), distributed.traffic.bytes_sent


def _cases():
    """(name, report, call) of every sharded path on a ``["cpu"] * n`` mesh."""
    dense_cfg = MatchConfig(num_disparities=16, window=5)
    sgm_cfg = MatchConfig(num_disparities=16, window=5, lr_threshold=1.0)
    hcfg = MatchConfig(num_disparities=32, window=9, cost="census", census_window=5)
    pyr = PyramidConfig(levels=3, refine_radius=4, coarsest_disparities=8)
    l64, r64 = _pair(64, 96, 4)
    l128, r128 = _pair(128, 96, 4, seed=1)
    lh, rh = _pair(128, 256, 6, seed=2)

    def mesh(n, data=1):
        return make_mesh(data=data, tile=n, devices=["cpu"] * (n * data))

    cases = []
    for n in (2, 4):
        cases.append((f"dense-{n}", cm.comm_dense_sharded(dense_cfg, 64, 96, n),
                      lambda n=n: sharded.match_pair_sharded(l64, r64, dense_cfg, mesh(n))))
    cases.append(("pallas-4", cm.comm_pallas_sharded(dense_cfg, 64, 96, 4),
                  lambda: sharded.match_pair_sharded_pallas(l64, r64, dense_cfg, mesh(4),
                                                            tile_rows=8)))
    for directions, exact in ((4, True), (8, True), (4, False)):
        sc = SGMConfig(directions=directions)
        tag = f"{directions}-{'exact' if exact else 'warmup'}"
        cases.append((f"sgm-{tag}", cm.comm_sgm_sharded(sgm_cfg, 128, 96, 4, directions, exact,
                                                        16),
                      lambda sc=sc, exact=exact: sgm_sharded.match_pair_sgm_sharded(
                          l128, r128, sgm_cfg, sc, mesh(4), exact=exact, warmup=16)))
        cases.append((f"sgm-pallas-{tag}", cm.comm_sgm_sharded(
            sgm_cfg, 128, 96, 4, directions, exact, 12, pallas=True),
            lambda sc=sc, exact=exact: sgm_pallas_sharded.match_pair_sgm_pallas_sharded(
                l128, r128, sgm_cfg, sc, mesh(4), exact=exact, warmup=12,
                stages=fused_refine.PLAIN)))
    for coarse in ("wta", "sgm"):
        cases.append((f"hierarchical-{coarse}", cm.comm_hierarchical_sharded(
            hcfg, pyr, 128, 256, 4, tile_rows=8, coarse_backend=coarse),
            lambda coarse=coarse: sharded.match_hierarchical_sharded(
                lh, rh, hcfg, pyr, mesh(4), tile_rows=8, coarse_backend=coarse, lr_check=True,
                stages=fused_refine.PLAIN)))
    cases.append(("batch-hierarchical", cm.comm_batch_hierarchical_sharded(2, 128, 256, 2),
                  lambda: sharded.match_batch_hierarchical_sharded(
                      np.stack([lh, rh]), np.stack([rh, lh]), hcfg, pyr, mesh(1, data=2),
                      tile_rows=8, lr_check=True, stages=fused_refine.PLAIN)))
    return cases


CASES = {name: (report, call) for name, report, call in _cases()}


@pytest.mark.parametrize("name", list(CASES))
def test_tally_equals_model(name):
    report, call = CASES[name]
    got, sent = _tallied(call)
    assert got == report.by_kind(), report.table()
    assert sent == 0  # one process sends nothing to others
    assert report.move_counts() > 0


def test_ba_tally_equals_model():
    """``make_problem`` (4 cameras × 64 points) over ``data=4``, 2 LM
    iterations of 3 CG steps: 28 gathers an iteration at ``cg_iters=10``,
    here 14, each a move from 3 shards."""
    prob, _, _ = make_problem(np.random.default_rng(0), n_cams=4, n_pts=64)
    problem = ba.problem_from_arrays(prob._asdict(), device="cpu")
    mesh = make_mesh(data=4, tile=1, devices=["cpu"] * 4)
    got, sent = _tallied(lambda: ba.solve_sharded(problem, mesh, iters=2, cg_iters=3))
    report = cm.comm_ba_sharded(4, 64, 2, 3, n=4)
    assert got == report.by_kind(), report.table()
    assert got["gather"][1] == 3 * (2 * (2 * 3 + 8) + 2)
    assert sent == 0
    # a single-shard solve gathers nothing
    got, _ = _tallied(lambda: ba.solve(problem, iters=1, cg_iters=2))
    assert got == {k: (0, 0, 0) for k in distributed.KINDS}


# ---- (c) the two-process drills' bytes, from shapes --------------------------


def test_drill_bytes_from_shapes():
    """``chip_smoke.py`` phase 8 (``drill.frame_drill``/``BA_SIZES`` at
    ``--size full``): production 1024×1920 on ``tile=4``, ``sgm-pallas``
    1088×1920 on ``tile=4`` and BA 4,096 points × 8 cameras on ``data=8``,
    two ranks owning contiguous halves; each rank's bytes a frame or solve
    as measured on the card."""
    prod = cm.comm_hierarchical_sharded(
        MatchConfig(num_disparities=128, window=9, cost="census"),
        PyramidConfig(levels=4, coarsest_disparities=16), 1024, 1920, 4, tile_rows=32)
    sgm = cm.comm_sgm_sharded(MatchConfig(num_disparities=64, window=5, cost="sad",
                                          lr_threshold=1.0), 1088, 1920, 4, directions=4,
                              exact=True, pallas=True)
    bundle = cm.comm_ba_sharded(8, 4096, lm_iters=10, cg_iters=10, n=8)
    for rank in (0, 1):
        assert cm.bytes_sent(prod, [0, 0, 1, 1], rank) == 6_274_688
        assert cm.bytes_sent(sgm, [0, 0, 1, 1], rank) == 9_945_792
        assert cm.bytes_sent(bundle, [0] * 4 + [1] * 4, rank) == 31_603_552
    # one process owning every slot sends nothing; a rank with no slot
    # sends only the gathers' headers
    assert cm.bytes_sent(prod, [0] * 4, 0) == 0
    assert cm.bytes_sent(prod, [0] * 4, 1, world=2) == 2 * distributed.HEADER_BYTES
    assert cm.bytes_sent(bundle, [0] * 8, 1, world=2) == 0
    with pytest.raises(ValueError, match="slots"):
        cm.bytes_sent(prod, [0, 1], 0)


# ---- (d) the projection --------------------------------------------------------


def test_projection_sanity():
    """As ``tests/test_comm_model.py``'s, at 1024 rows (1080 admits no
    8-shard mesh at ``levels=4``); the compute time is an input, not a
    measurement."""
    cfg = MatchConfig(num_disparities=128, window=9)
    pyr = PyramidConfig(levels=4, refine_radius=4, coarsest_disparities=16)
    rep = cm.comm_hierarchical_sharded(cfg, pyr, 1024, 1920, 8)
    p1 = cm.project(rep, compute_ms_1chip=20.0, n_devices=8, n_hosts=1)
    p2 = cm.project(rep, compute_ms_1chip=20.0, n_devices=8, n_hosts=2)
    assert 0 < p2.efficiency <= p1.efficiency <= 1.0
    assert p1.efficiency > 0.8, p1
    sgm_rep = cm.comm_sgm_sharded(MatchConfig(num_disparities=64, window=5), 1088, 1920, 8,
                                  pallas=True)
    assert cm.project(sgm_rep, compute_ms_1chip=4.0, n_devices=8).comm_ms > 0
    # relays rescale with the card count; a report built for one card refuses
    for n in (2, 4, 16):
        fresh = cm.comm_sgm_sharded(MatchConfig(num_disparities=64, window=5), 1088, 1920, n,
                                    pallas=True)
        relay = [c for c in sgm_rep.collectives if c.serial_hops]
        scaled = cm.project(cm.CommReport("relay", tuple(relay), 8), 4.0, n)
        again = cm.project(cm.CommReport("relay", tuple(c for c in fresh.collectives
                                                        if c.serial_hops), n), 4.0, n)
        assert abs(scaled.comm_ms - again.comm_ms) < 1e-12
    one = cm.comm_sgm_sharded(MatchConfig(num_disparities=64, window=5), 1088, 1920, 1)
    with pytest.raises(ValueError, match="built for n=1"):
        cm.project(one, compute_ms_1chip=4.0, n_devices=8)


@pytest.mark.parametrize("n_hosts", [1, 2])
def test_projection_equals_reference_on_the_same_exchanges(n_hosts):
    """The neighbour exchanges and relays of the dense and SGM paths, which
    the two models state alike, projected with the JAX model's link rates:
    the same milliseconds."""
    kw = dict(num_disparities=64, window=5)
    for n in (2, 4, 8):
        for want, got in (
                (ref_cm.comm_sgm_sharded(RefMatchConfig(**kw), 1088, 1920, n),
                 cm.comm_sgm_sharded(MatchConfig(**kw), 1088, 1920, n)),
                (ref_cm.comm_dense_sharded(RefMatchConfig(**kw), 1088, 1920, n),
                 cm.comm_dense_sharded(MatchConfig(**kw), 1088, 1920, n))):
            permutes = cm.CommReport(got.name, tuple(c for c in got.collectives
                                                     if c.kind == "permute"), got.n)
            for devices in (2, 4, 8):
                if n_hosts > devices:
                    continue
                a = ref_cm.project(want, 6.0, devices, n_hosts, ici_gbps=45.0, dcn_gbps=25.0)
                b = cm.project(permutes, 6.0, devices, n_hosts, nvlink_gbps=45.0, net_gbps=25.0)
                assert abs(a.comm_ms - b.comm_ms) < 1e-12 and a.efficiency == pytest.approx(
                    b.efficiency, rel=1e-12)


def test_tally_is_plain_arithmetic():
    """The tally needs no card and no synchronisation: a move is counted
    from shapes, and ``reset`` zeroes every kind."""
    t = distributed.Traffic()
    t.move("permute", 12, serial=True)
    t.move("gather", 5)
    assert (t.moved, t.moves, t.serial) == (
        {"permute": 12, "gather": 5, "max": 0}, {"permute": 1, "gather": 1, "max": 0},
        {"permute": 1, "gather": 0, "max": 0})
    t.bytes_sent = 3
    t.reset()
    assert t == distributed.Traffic()

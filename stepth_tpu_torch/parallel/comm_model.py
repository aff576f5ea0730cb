"""Per-frame communication of the sharded paths, and a scaling projection
(twin of ``stepth_tpu/parallel/comm_model.py``).

Every sharded path moves data between the slots of a mesh: halo slabs and
relayed carries between neighbours (``permute``), result blocks and bundle
adjustment's partials onto one slot or, across processes, to every process
(``gather``), and the depth map's global max (``max``). The builders give
each path's moves from its configuration and shapes alone. A
:class:`Collective` is one exchange of the per-shard program:

* ``payload_bytes``: what one slot sends in one run of it (per slot, as the
  JAX model defines its payloads: one device's payload for each op);
* ``count``: its runs per frame or solve (``serial_hops`` > 0 marks a relay
  chain, whose hops are its runs);
* ``links``: the moves between two slots one run makes on a one-process mesh
  (``n − 1`` for a halo direction or a gather onto one slot, 1 for a hop);
* ``header``: whether a gather across processes first sends the 64-byte
  shape header (the caller states no shape).

So :meth:`CommReport.op_bytes` compares directly with the JAX model's;
:meth:`CommReport.moved_bytes` and :meth:`CommReport.move_counts` are what
``distributed.traffic`` tallies on a one-process mesh, kind by kind; and
:func:`bytes_sent` is what one process sends for given slot owners
(``distributed.traffic.bytes_sent``). The JAX package holds its model to the
compiled HLO; the port holds this one to its own transport record
(``tests/test_torch_comm_model.py`` on the CPU, ``chip_smoke.py`` phase 9 on
the card). The builders size halos and tiles through the sharded paths' own
functions (``sharded.required_halo``, ``sharded.sublane_halo``,
``sharded._hierarchical_geometry``), so the model cannot drift from them
silently.

Where the port's moves differ from the JAX model's collectives:

* the hierarchical paths' final median takes a one-row halo (the JAX path
  exchanges ``halo`` rows and reads one);
* every sharded match gathers its result (disparity, validity and, where
  the path keeps one, cost) onto one slot; ``shard_map`` leaves the
  reference's sharded, with no collective;
* bundle adjustment gathers each partial in shard order and sums it there
  (the reference's ``psum`` is an all-reduce), and its accept test sums one
  scalar per cost (the reference's two, the weight sum again): 8 bytes an
  LM iteration fewer.

:func:`project` is a model, not a measurement (no machine here holds two
cards): the JAX model's roofline structure, with link rates of this card's
class stated as assumptions (see its docstring).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

from stepth_tpu_torch.config import MatchConfig, PyramidConfig
from stepth_tpu_torch.match.fused_refine import _round_up
from stepth_tpu_torch.parallel.distributed import HEADER_BYTES, KINDS
from stepth_tpu_torch.parallel.sharded import (
    _hierarchical_geometry, required_halo, sublane_halo,
)

F32, BOOL = 4, 1  # bytes of a gray, disparity or cost element; of a validity element

# Link rates assumed by :func:`project` (GB/s, one way), not measured here:
# 0.9 of NVLink 4's 450 GB/s each way per H100 SXM (NVIDIA's H100 data
# sheet: 900 GB/s bidirectional), and 0.9 of one ConnectX-7 NDR port's
# 400 Gb/s (50 GB/s) between hosts, one port per card as in a DGX H100.
NVLINK_GBPS = 405.0
NET_GBPS = 45.0


@dataclasses.dataclass(frozen=True)
class Collective:
    """One exchange of the per-shard program (see the module docstring)."""

    kind: str  # "permute" | "gather" | "max"
    label: str
    payload_bytes: int
    count: int
    serial_hops: int = 0
    links: int = 1
    header: bool = False


@dataclasses.dataclass(frozen=True)
class CommReport:
    """A path's exchanges per frame or solve. ``n``: the slots of the
    sharded axis the report was built for (relay hop counts are
    proportional to ``n − 1``, which :func:`project` rescales)."""

    name: str
    collectives: Tuple[Collective, ...]
    n: Optional[int] = None

    def _sum(self, value, kind, serial=None) -> int:
        return sum(value(c) for c in self.collectives
                   if (kind is None or c.kind == kind)
                   and (serial is None or bool(c.serial_hops) == serial))

    def op_bytes(self, kind: Optional[str] = None) -> int:
        """Σ payload·count: one slot's bytes, the JAX model's measure."""
        return self._sum(lambda c: c.payload_bytes * c.count, kind)

    def op_counts(self, kind: Optional[str] = None, serial: Optional[bool] = None) -> int:
        """Σ count (``serial``: relay hops only, or none of them)."""
        return self._sum(lambda c: c.count, kind, serial)

    def moved_bytes(self, kind: Optional[str] = None) -> int:
        """Σ payload·count·links: the payload moved between slots of a
        one-process mesh (``distributed.traffic.moved``)."""
        return self._sum(lambda c: c.payload_bytes * c.count * c.links, kind)

    def move_counts(self, kind: Optional[str] = None, serial: Optional[bool] = None) -> int:
        """Σ count·links: the moves of a one-process mesh
        (``distributed.traffic.moves``; ``serial=True``: ``.serial``)."""
        return self._sum(lambda c: c.count * c.links, kind, serial)

    def by_kind(self):
        """``{kind: (moved bytes, moves, relay hops)}`` of a one-process
        mesh: what ``distributed.traffic.by_kind()`` reads after one call."""
        return {k: (self.moved_bytes(k), self.move_counts(k), self.move_counts(k, serial=True))
                for k in KINDS}

    def table(self) -> str:
        rows = [f"  {c.kind:8s} {c.label:48s} {c.payload_bytes / 1e3:10.1f} kB × {c.count}"
                f" × {c.links} links" for c in self.collectives]
        return "\n".join(rows + [f"  total per slot: {self.op_bytes() / 1e6:.3f} MB, moved: "
                                 f"{self.moved_bytes() / 1e6:.3f} MB"])


def _halos(label: str, arrays: int, rows: int, w: int, n: int) -> Collective:
    """``arrays`` f32 slabs ``[rows, w]`` to each neighbour, both ways."""
    return Collective("permute", f"{label} {arrays} × 2 dirs [{rows},{w}]", F32 * rows * w,
                      2 * arrays, links=max(n - 1, 0))


def _relay(label: str, directions: int, w: int, d: int, n: int):
    """The carry relay of the vertical and diagonal directions, f32
    ``[W, D]`` a hop, ``n − 1`` hops each; none on one shard."""
    chains = (2 if directions >= 4 else 0) + (4 if directions == 8 else 0)
    if not chains or n <= 1:
        return []
    hops = chains * (n - 1)
    return [Collective("permute", f"{label} {chains} dirs × (n−1) hops [{w},{d}]",
                       F32 * w * d, hops, serial_hops=hops)]


def _gathers(th: int, w: int, n: int, cost: bool = True):
    """The result's blocks ``[th, w]`` gathered onto one slot."""
    fields = [("disparity", F32), ("valid", BOOL)] + ([("cost", F32)] if cost else [])
    return [Collective("gather", f"result {name} [{th},{w}]", size * th * w, 1,
                       links=max(n - 1, 0), header=True) for name, size in fields]


def comm_dense_sharded(cfg: MatchConfig, H: int, W: int, n: int) -> CommReport:
    """Moves of :func:`parallel.sharded.match_pair_sharded` (``dense``)."""
    halo = required_halo(cfg)
    return CommReport("match_pair_sharded", (
        _halos("image halos", 2, halo, W, n),
        _halos("median disparity halo", 1, 1, W, n),
        *_gathers(H // n, W, n)), n=n)


def comm_pallas_sharded(cfg: MatchConfig, H: int, W: int, n: int) -> CommReport:
    """Moves of :func:`parallel.sharded.match_pair_sharded_pallas`
    (``flagship()`` sharded): no JAX model has them."""
    halo = sublane_halo(cfg)
    return CommReport("match_pair_sharded_pallas", (
        _halos("image halos", 2, halo, W, n),
        _halos("median disparity halo", 1, 1, W, n),
        *_gathers(H // n, W, n)), n=n)


def comm_hierarchical_sharded(
    cfg: MatchConfig,
    pyr: PyramidConfig,
    H: int,
    W: int,
    n: int,
    tile_rows: int = 32,
    coarse_backend: str = "wta",
    coarse_sgm_directions: int = 4,
) -> CommReport:
    """Moves of :func:`parallel.sharded.match_hierarchical_sharded` (with or
    without ``lr_check``: the right view moves nothing)."""
    _, halo = _hierarchical_geometry(H, n, cfg, pyr, tile_rows)
    lc = pyr.levels - 1
    W_c = W >> lc
    cols = []
    if coarse_backend == "wta":
        cols.append(_halos("coarse l/r halos", 2, halo, W_c, n))
    else:  # the plain-torch SGM: its halos, its exact carry relay, its median
        coarse_cfg = dataclasses.replace(cfg, num_disparities=pyr.coarsest_disparities,
                                         lr_threshold=None)
        cols.append(_halos("sgm-coarse l/r halos", 2, required_halo(coarse_cfg), W_c, n))
        cols += _relay("sgm-coarse carry relay", coarse_sgm_directions, W_c,
                       pyr.coarsest_disparities, n)
        cols.append(_halos("sgm-coarse median halo", 1, 1, W_c, n))
    for lvl in range(lc - 1, -1, -1):
        cols.append(_halos(f"refine L{lvl} l/r/prior halos", 3, halo, W >> lvl, n))
    cols.append(_halos("final median halo", 1, 1, W, n))
    return CommReport(f"match_hierarchical_sharded[{coarse_backend}]",
                      tuple(cols + _gathers(H // n, W, n, cost=False)), n=n)


def comm_sgm_sharded(
    cfg: MatchConfig, H: int, W: int, n: int, directions: int = 4,
    exact: bool = True, warmup: int = 32, pallas: bool = False,
) -> CommReport:
    """Moves of :func:`parallel.sgm_sharded.match_pair_sgm_sharded` (``sgm``)
    or, with ``pallas``, of ``sgm_pallas_sharded.match_pair_sgm_pallas_sharded``
    (its warm-up rounded up to 8 rows); the two relays move the same carry."""
    wu = 0 if exact else (_round_up(int(warmup), 8) if pallas else int(warmup))
    ext = required_halo(cfg) + wu
    cols = [_halos("l/r halos", 2, ext, W, n), _halos("median halo", 1, 1, W, n)]
    if exact:
        cols += _relay("carry relay", directions, W, cfg.num_disparities, n)
    name = "match_pair_sgm_pallas_sharded" if pallas else "match_pair_sgm_sharded"
    return CommReport(name, tuple(cols + _gathers(H // n, W, n)), n=n)


def comm_batch_hierarchical_sharded(B: int, H: int, W: int, data: int) -> CommReport:
    """Moves of :func:`parallel.sharded.match_batch_hierarchical_sharded`:
    each frame of a data row other than the first moves its result onto
    the first slot (one process), or every process's frames go to every
    other process. Its slots are the ``B`` frames."""
    per_row = B // data
    return CommReport("match_batch_hierarchical_sharded", tuple(
        Collective("gather", f"frame {name} [{H},{W}]", size * H * W, 1, links=B - per_row,
                   header=True)
        for name, size in (("disparity", F32), ("valid", BOOL), ("cost", F32))), n=B)


def comm_ba_sharded(C: int, Pn: int, lm_iters: int = 10, cg_iters: int = 10,
                    n: int = 8) -> CommReport:
    """Gathers of :func:`fusion.ba.solve_sharded` per solve over ``n``
    observation shards. Per LM iteration (``ba._schur_system``): the camera
    and point blocks [C,42] and [P,12], the Schur right-hand side [C,6];
    ``S_apply``'s two ([P,3], [C,6]) once for r0 and once per CG iteration;
    the back-substitution [P,3]; the accept test's two costs (a scalar
    each); at the start the weight sum and the cost. Each partial is f32;
    BA states every shape, so no header."""
    per_lm = [("cameras [C,42]", C * 42, 1), ("points [P,12]", Pn * 12, 1),
              ("Schur rhs [C,6]", C * 6, 1), ("S_apply [P,3]", Pn * 3, cg_iters + 1),
              ("S_apply [C,6]", C * 6, cg_iters + 1), ("back-substitute [P,3]", Pn * 3, 1),
              ("cost scalars", 1, 2)]
    cols = [Collective("gather", f"{label} × {lm_iters} LM (C={C}, P={Pn}, cg={cg_iters})",
                       F32 * size, k * lm_iters, links=n - 1) for label, size, k in per_lm]
    cols.append(Collective("gather", "initial weight sum and cost", F32, 2, links=n - 1))
    return CommReport("ba.solve_sharded", tuple(cols), n=n)


def bytes_sent(report: CommReport, owners: Sequence[int], rank: int,
               world: Optional[int] = None) -> int:
    """The bytes process ``rank`` sends to other processes for ``report``
    when slot ``i`` of its sharded axis belongs to process ``owners[i]``
    (``world``: the processes of the group, by default ``max(owners) +
    1``): a neighbour exchange or a relay hop where its two slots belong to
    different processes, by the sender; a gather's parts of this process to
    every other process, after the header where the caller states no shape;
    the max's 8 bytes to every other process."""
    owners = list(owners)
    if report.n != len(owners):
        raise ValueError(f"{report.name} was built for {report.n} slots, got {len(owners)} owners")
    world = max(owners) + 1 if world is None else world
    n = len(owners)
    # slots of ``rank`` whose neighbour below (above) is another process's
    down = sum(owners[i] == rank != owners[i + 1] for i in range(n - 1))
    up = sum(owners[i] == rank != owners[i - 1] for i in range(1, n))
    mine = owners.count(rank)
    total = 0
    for c in report.collectives:
        if c.kind == "permute":
            chains = c.count // (n - 1) if c.serial_hops else c.count  # half of them downward
            total += c.payload_bytes * chains // 2 * (down + up)
        elif c.kind == "gather":
            total += c.count * (world - 1) * (c.payload_bytes * mine
                                              + (HEADER_BYTES if c.header else 0))
        elif c.kind == "max":
            total += c.count * (world - 1) * c.payload_bytes
        else:
            raise ValueError(f"unknown kind {c.kind!r}; the kinds are {KINDS}")
    return total


@dataclasses.dataclass(frozen=True)
class Projection:
    n_devices: int
    n_hosts: int
    compute_ms: float  # per-card compute after 1/n scaling
    comm_ms: float  # critical-path communication
    efficiency: float  # vs perfect linear scaling


def project(
    report: CommReport,
    compute_ms_1chip: float,
    n_devices: int,
    n_hosts: int = 1,
    nvlink_gbps: float = NVLINK_GBPS,
    net_gbps: float = NET_GBPS,
) -> Projection:
    """Roofline efficiency of ``report`` on ``n_devices`` cards over
    ``n_hosts`` hosts (contiguous row blocks per host: hosts − 1 network
    boundaries), the JAX model's structure: a neighbour exchange runs on
    parallel links (one payload per run, on the slowest link class
    present); a relay chain pays every hop, the hosts − 1 boundary hops per
    chain over the network; a gather brings the n − 1 other slots' payloads
    to each card over the slowest class (a ring all-gather's wire time); a
    max pays an all-reduce's 2(n − 1)/n. No overlap of compute and
    communication is assumed. ``compute_ms_1chip`` is the caller's
    unsharded frame time on the card, divided by n.

    The link rates are assumptions, not measurements: ``nvlink_gbps``
    within a host (default :data:`NVLINK_GBPS`: 0.9 of NVLink 4's 450 GB/s
    each way per H100 SXM, from NVIDIA's data sheet) and ``net_gbps``
    between hosts (default :data:`NET_GBPS`: 0.9 of a ConnectX-7 NDR 400
    Gb/s port). Relay hop counts are rescaled from ``report.n`` to
    ``n_devices``; halo, tile and block sizes stay as built, so rebuild the
    report per n for exact payloads. A report built for n = 1 has no relay
    and cannot be projected to more cards."""
    if report.n == 1 and n_devices > 1:
        raise ValueError(f"report {report.name!r} was built for n=1 (relay collectives "
                         f"elided); rebuild it with n={n_devices} before projecting")
    fast, net = nvlink_gbps * 1e9, net_gbps * 1e9
    slow = net if n_hosts > 1 else fast
    comm_s = 0.0
    for c in report.collectives:
        if c.kind == "gather":
            comm_s += c.count * (n_devices - 1) * c.payload_bytes / slow
        elif c.kind == "max":
            comm_s += c.count * 2.0 * (n_devices - 1) / n_devices * c.payload_bytes / slow
        elif c.serial_hops:
            built_n = report.n if report.n is not None else n_devices
            per_round = c.count // max(built_n - 1, 1)
            hops = per_round * max(n_devices - 1, 0)
            net_hops = per_round * (n_hosts - 1) if n_hosts > 1 and n_devices > 1 else 0
            comm_s += (hops - net_hops) * c.payload_bytes / fast + net_hops * c.payload_bytes / net
        else:
            comm_s += c.count * c.payload_bytes / slow
    compute_ms = compute_ms_1chip / n_devices
    comm_ms = comm_s * 1e3
    eff = compute_ms / (compute_ms + comm_ms) if compute_ms > 0 else 0.0
    return Projection(n_devices, n_hosts, compute_ms, comm_ms, eff)

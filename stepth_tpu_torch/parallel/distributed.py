"""Multi-process bring-up and the cross-process transport (twin of
``stepth_tpu/parallel/distributed.py``).

The reference starts JAX's coordination service and lets XLA's collectives
move data between processes. Here the same roles fall to
``torch.distributed``:

* :func:`initialize` builds the rendezvous (a ``TCPStore``) and the
  process group;
* :func:`global_mesh` lays one ``(data, tile)`` mesh over every process's
  devices, process-major as ``jax.devices()`` orders them;
* :func:`transfer`, :func:`all_gather_ordered` and :func:`max_over_ranks`
  are the transport: every byte that crosses a process boundary goes
  through them (halos and relayed carries in :mod:`.sharded`,
  :mod:`.sgm_sharded` and :mod:`.sgm_pallas_sharded`, gathered results,
  the depth map's global max, bundle adjustment's partial sums). Slots of
  one process never reach them: those move with ``.to(device)``.

Backends. ``gloo`` runs everywhere; its point-to-point and gather
operations take CPU tensors only, so CUDA tensors are staged through
pinned host buffers (a device-to-host copy, the transfer, a host-to-device
copy: each waits for the card). ``nccl`` moves CUDA tensors directly and
needs one card per process; :func:`global_mesh` refuses two processes on
one card. The backend is always the caller's choice; nothing switches it.

Failure detection: a peer that dies closes its connections, and the next
transfer or collective that needs it raises at once; a peer that hangs
makes it raise after ``heartbeat_timeout_s``. A process that catches such
an error should leave with ``os._exit``: the process group's threads may
block an orderly interpreter shutdown once a peer is gone.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from stepth_tpu_torch.parallel.mesh import Mesh

# the dtypes the ordered gather can carry, by code
_DTYPES = (torch.float32, torch.float64, torch.float16, torch.bfloat16, torch.int64,
           torch.int32, torch.int16, torch.int8, torch.uint8, torch.bool)
_MAX_DIMS = 6


# the kinds of move between two slots of a mesh that :class:`Traffic` tallies
KINDS = ("permute", "gather", "max")
HEADER_BYTES = (2 + _MAX_DIMS) * 8  # a gather's shape header, when the caller states none


def _tally() -> Dict[str, int]:
    return dict.fromkeys(KINDS, 0)


@dataclasses.dataclass
class Traffic:
    """What this process moved; plain counters callers may reset.

    * ``bytes_sent``: bytes sent to other processes (payloads and the
      gather's headers).
    * ``moved``, ``moves`` and ``serial``, by kind: the payload bytes and
      the number of moves between two slots of a mesh, and how many of
      those moves were hops of a relay chain. ``permute``: a halo slab
      (:func:`stepth_tpu_torch.parallel.sharded.halo_exchange_rows`) or a
      relayed carry (``sgm_sharded.relay_carry``, serial); ``gather``: a
      block of a gathered result or a partial of bundle adjustment, onto
      the gathering slot, or, across processes, this process's parts to
      each other process (the shape header, where sent, adds its bytes);
      ``max``: :func:`max_over_ranks`'s value to each other process.
      Slots of one process count their moves even where both sit on one
      device: those are the moves that would cross cards. Not counted:
      copies of the inputs or of replicated state onto a slot's device.

    :mod:`stepth_tpu_torch.parallel.comm_model` predicts all of these."""

    bytes_sent: int = 0
    moved: Dict[str, int] = dataclasses.field(default_factory=_tally)
    moves: Dict[str, int] = dataclasses.field(default_factory=_tally)
    serial: Dict[str, int] = dataclasses.field(default_factory=_tally)

    def reset(self) -> None:
        self.bytes_sent = 0
        for d in (self.moved, self.moves, self.serial):
            d.update(_tally())

    def move(self, kind: str, nbytes: int, serial: bool = False) -> None:
        """One move of ``nbytes`` payload bytes between two slots."""
        self.moved[kind] += nbytes
        self.moves[kind] += 1
        self.serial[kind] += int(serial)

    def by_kind(self) -> Dict[str, Tuple[int, int, int]]:
        """``{kind: (payload bytes, moves, relay hops)}``, as
        ``comm_model.CommReport.by_kind`` predicts them."""
        return {k: (self.moved[k], self.moves[k], self.serial[k]) for k in KINDS}


traffic = Traffic()


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    heartbeat_timeout_s: int = 100,
    initialization_timeout_s: int = 300,
    backend: str = "gloo",
    store: Optional[dist.Store] = None,
) -> None:
    """Join ``num_processes`` processes into one process group.

    Does nothing for one process (``num_processes`` defaults to
    ``STEPTH_NUM_PROCESSES``, else 1). Two distinct timeouts, as in the
    reference:

    * ``initialization_timeout_s`` bounds *startup*: how long the
      rendezvous store waits for every process to arrive;
    * ``heartbeat_timeout_s`` is the *runtime* failure detector: a transfer
      or collective that waits longer than this on a peer raises instead
      of hanging.

    The rendezvous is a ``TCPStore`` at ``coordinator_address``
    (``"host:port"``) served by process 0, or ``store`` when the caller
    already holds one (e.g. a client of a store its launcher serves). A
    rendezvous that fails raises; it never falls back to one process.
    """
    if num_processes is None:
        num_processes = int(os.environ.get("STEPTH_NUM_PROCESSES", "1"))
    if num_processes <= 1:
        return
    if process_id is None:
        raise ValueError("initialize: process_id is required with more than one process")
    if store is None:
        if coordinator_address is None:
            raise ValueError("initialize: coordinator_address ('host:port') or store is "
                             "required with more than one process")
        host, port = coordinator_address.rsplit(":", 1)
        store = dist.TCPStore(host, int(port), num_processes, is_master=process_id == 0,
                              timeout=datetime.timedelta(seconds=initialization_timeout_s))
    dist.init_process_group(backend, store=store, rank=process_id, world_size=num_processes,
                            timeout=datetime.timedelta(seconds=heartbeat_timeout_s))


def process_info() -> Tuple[int, int]:
    """(process_index, process_count); ``(0, 1)`` with no process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def is_coordinator() -> bool:
    return process_info()[0] == 0


def barrier() -> None:
    """Wait for every process (nothing to wait for with one)."""
    if process_info()[1] > 1:
        dist.barrier()


def _card_uuid(d: torch.device) -> Optional[str]:
    if d.type != "cuda":
        return None
    return str(torch.cuda.get_device_properties(d).uuid)


def global_mesh(data: int = 1, tile: Optional[int] = None,
                devices: Optional[Sequence] = None) -> Mesh:
    """Build the ``(data, tile)`` mesh over ALL processes' devices.
    ``devices`` are this process's own (by default every visible CUDA
    device; with none it raises, as ``make_mesh`` does); every process's
    list is exchanged and laid out in rank order, so a data row's ``tile``
    slots are as many neighbours of one process as it holds (halos between
    them stay local) and the ``data`` axis is outermost. Under ``nccl``
    each process must hold one card and no two processes the same one."""
    if devices is None:
        n_cuda = torch.cuda.device_count()
        if n_cuda == 0:
            raise RuntimeError("global_mesh: no CUDA device is visible; pass devices= "
                               "(e.g. ['cpu'] * 4) for a mesh on other devices")
        devices = [torch.device("cuda", i) for i in range(n_cuda)]
    devices = [torch.device(d) for d in devices]
    rank, world = process_info()
    mine = ([str(d) for d in devices], sorted({u for u in map(_card_uuid, devices) if u}))
    every = [mine]
    if world > 1:
        every = [None] * world
        dist.all_gather_object(every, mine)
        if dist.get_backend() == "nccl":
            _check_one_card_each(every)
            torch.cuda.set_device(devices[0])
    flat = [(r, torch.device(d)) for r, (names, _) in enumerate(every) for d in names]
    n = len(flat)
    if tile is None:
        tile = n // data
    if data * tile != n:
        raise ValueError(f"mesh {data}x{tile} != {n} devices")
    grid = [flat[i * tile:(i + 1) * tile] for i in range(data)]
    return Mesh(tuple(tuple(d for _, d in row) for row in grid),
                tuple(tuple(r for r, _ in row) for row in grid), rank)


def _check_one_card_each(every) -> None:
    """NCCL: one card per process, and no card in two processes."""
    owner = {}
    for r, (names, uuids) in enumerate(every):
        if len(uuids) != 1 or any(not n.startswith("cuda") for n in names):
            raise ValueError(f"nccl: rank {r} must hold exactly one CUDA card, has {names}")
        if uuids[0] in owner:
            raise ValueError(f"nccl: ranks {owner[uuids[0]]} and {r} name the same card "
                             f"{uuids[0]}; NCCL needs one card per rank (use gloo)")
        owner[uuids[0]] = r


# ---- the transport -------------------------------------------------------


def _staged() -> bool:
    """Whether CUDA tensors must pass through the host (gloo)."""
    return dist.get_backend() != "nccl"


def _to_wire(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the backend takes it: contiguous, on the host (pinned when
    it comes from a card) under gloo, on the card under nccl."""
    t = t.contiguous()
    if _staged():
        if t.is_cuda:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t)
            return buf
        return t
    return t if t.is_cuda else t.cuda()


def _wire_buffer(shape, dtype, device: torch.device) -> torch.Tensor:
    if _staged():
        return torch.empty(shape, dtype=dtype, pin_memory=device.type == "cuda")
    return torch.empty(shape, dtype=dtype,
                       device=device if device.type == "cuda" else torch.cuda.current_device())


class Send(NamedTuple):
    """A tensor for process ``dst``, matched there by ``tag``."""

    tensor: torch.Tensor
    dst: int
    tag: int


class Recv(NamedTuple):
    """A tensor of ``shape`` and ``dtype`` from process ``src`` (matched by
    ``tag``), delivered on ``device``."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    device: torch.device
    src: int
    tag: int


def transfer(sends: Sequence[Send], recvs: Sequence[Recv], serial: bool = False
             ) -> List[torch.Tensor]:
    """Move slabs between slots of different processes: post every send and
    receive of this process at once (``batch_isend_irecv``), so a two-way
    halo exchange cannot deadlock, and wait for all of them. Returns the
    received tensors, in the order of ``recvs``, each on its device. Every
    process must post the matching side of each transfer; a peer that died
    or hangs makes this raise. Each send is a ``permute`` move (``serial``:
    a hop of a relay chain)."""
    if not sends and not recvs:
        return []
    out = [_wire_buffer(r.shape, r.dtype, r.device) for r in recvs]
    ops = [dist.P2POp(dist.isend, _to_wire(s.tensor), s.dst, tag=s.tag) for s in sends]
    ops += [dist.P2POp(dist.irecv, buf, r.src, tag=r.tag) for buf, r in zip(out, recvs)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    for s in sends:
        nbytes = s.tensor.numel() * s.tensor.element_size()
        traffic.bytes_sent += nbytes
        traffic.move("permute", nbytes, serial)
    return [buf.to(r.device) for buf, r in zip(out, recvs)]


def all_gather_ordered(parts: Sequence[torch.Tensor], owners: Sequence[int], device,
                       like: Optional[Tuple[Tuple[int, ...], torch.dtype]] = None
                       ) -> List[torch.Tensor]:
    """Every slot's tensor on every process, in slot order, on ``device``.

    ``owners[s]`` is the rank owning slot ``s``; ``parts`` are this
    process's tensors for its slots, in slot order (possibly none). The
    parts of one process must share a shape and dtype. ``like``, the
    ``(shape, dtype)`` of every part of every process, is given by callers
    that know it; else a fixed-size header (shape, dtype) from every
    process comes first. Then one collective moves the parts' bytes, padded
    to the longest. This process's own parts are returned as given, moved to
    ``device``, so a sum over the result in slot order is the
    single-process sum bit for bit."""
    device = torch.device(device)
    rank, world = process_info()
    counts = [sum(1 for o in owners if o == r) for r in range(world)]
    if counts[rank] != len(parts):
        raise ValueError(f"rank {rank} owns {counts[rank]} slots, got {len(parts)} parts")
    want = (parts[0].shape, parts[0].dtype) if like is None and parts else like
    if parts and any(p.shape != want[0] or p.dtype != want[1] for p in parts):
        raise ValueError(f"all_gather_ordered: parts must share one shape and dtype "
                         f"({tuple(want[0])}, {want[1]}); got "
                         f"{[(tuple(p.shape), p.dtype) for p in parts]}")
    metas = [like] * world if like is not None else _exchange_metas(parts)
    nbytes = [c * (torch.Size(m[0]).numel() * m[1].itemsize if c else 0)
              for c, m in zip(counts, metas)]
    longest = max(nbytes)
    payload = torch.zeros(longest, dtype=torch.uint8, device=parts[0].device if parts else "cpu")
    if parts:
        flat = torch.cat([p.contiguous().reshape(-1).view(torch.uint8) for p in parts])
        payload[:flat.numel()] = flat
    bufs = [_wire_buffer((longest,), torch.uint8, payload.device) for _ in range(world)]
    dist.all_gather(bufs, _to_wire(payload))
    traffic.bytes_sent += nbytes[rank] * (world - 1)
    for p in parts:
        for _ in range(world - 1):
            traffic.move("gather", p.numel() * p.element_size())
    by_rank = {rank: [p.to(device) for p in parts]}
    for r, (count, (shape, dtype)) in enumerate(zip(counts, metas)):
        if r != rank:
            raw = bufs[r][:nbytes[r]].to(device)
            step = nbytes[r] // max(count, 1)
            by_rank[r] = [raw[k * step:(k + 1) * step].view(dtype).reshape(shape)
                          for k in range(count)]
    taken = {r: 0 for r in by_rank}
    out = []
    for r in owners:
        out.append(by_rank[r][taken[r]])
        taken[r] += 1
    return out


def _exchange_metas(parts: Sequence[torch.Tensor]):
    """Every process's ``(shape, dtype)`` of its parts (``((), None)`` for a
    process with none), through one all-gather of a fixed-size header."""
    world = process_info()[1]
    hdr = torch.full((2 + _MAX_DIMS,), -1, dtype=torch.int64)
    if parts:
        if parts[0].ndim > _MAX_DIMS:
            raise ValueError(f"all_gather_ordered: parts of at most {_MAX_DIMS} dims, "
                             f"got {parts[0].ndim}")
        hdr[0], hdr[1] = _DTYPES.index(parts[0].dtype), parts[0].ndim
        hdr[2:2 + parts[0].ndim] = torch.tensor(parts[0].shape)
    hdrs = [_wire_buffer(hdr.shape, hdr.dtype, torch.device("cpu")) for _ in range(world)]
    dist.all_gather(hdrs, _to_wire(hdr))
    traffic.bytes_sent += HEADER_BYTES * (world - 1)
    traffic.moved["gather"] += HEADER_BYTES * (world - 1)
    metas = []
    for h in hdrs:
        h = h.cpu()
        if int(h[0]) < 0:
            metas.append(((), None))
        else:
            metas.append((tuple(int(v) for v in h[2:2 + int(h[1])]), _DTYPES[int(h[0])]))
    return metas


def max_over_ranks(value: float) -> float:
    """The largest of every process's ``value`` (itself with one process)."""
    if process_info()[1] == 1:
        return value
    t = torch.tensor([float(value)], dtype=torch.float64)
    if not _staged():
        t = t.cuda()
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    traffic.bytes_sent += 8 * (dist.get_world_size() - 1)
    for _ in range(dist.get_world_size() - 1):
        traffic.move("max", 8)
    return float(t.item())

"""Device meshes (twin of ``stepth_tpu/parallel/mesh.py``).

A :class:`Mesh` is a ``(data, tile)`` grid of ``torch.device``s: stereo
pairs of a batch shard over ``data``, image rows over ``tile``. Each slot
also names the process (rank) that owns it. The reference is
single-controller per process — ``shard_map`` runs every addressable shard
of a mesh and ``ppermute``/``psum`` move data between devices — and so is
the port: the per-shard code is a Python loop over the slots this process
owns, halos and relayed carries move between them with ``.to(device)``,
and only a slot of another process is reached through
:mod:`stepth_tpu_torch.parallel.distributed`'s transport.
:func:`make_mesh` builds a mesh whose slots are all this process's;
``distributed.global_mesh`` one over every process's devices.

The same device may appear more than once, so ``["cuda:0"] * 3`` runs three
real shards (real seams, a real carry relay) on one card, and ``["cpu"] *
8`` is the tests' mesh; distinct cards run the same code.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import torch


class Row(NamedTuple):
    """The ``tile`` slots of one data row: their devices, the rank owning
    each, and this process's rank."""

    devices: Tuple[torch.device, ...]
    ranks: Tuple[int, ...]
    this_rank: int = 0

    def is_local(self, i: int) -> bool:
        return self.ranks[i] == self.this_rank


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices[data][tile]``: row ``i`` holds the tile devices of data
    shard ``i``; ``ranks[data][tile]`` the process owning each slot (all
    ``this_rank`` when not given)."""

    devices: Tuple[Tuple[torch.device, ...], ...]
    ranks: Optional[Tuple[Tuple[int, ...], ...]] = None
    this_rank: int = 0

    def __post_init__(self):
        if self.ranks is None:
            object.__setattr__(self, "ranks",
                               tuple((self.this_rank,) * len(r) for r in self.devices))

    @property
    def shape(self) -> dict:
        return {"data": len(self.devices), "tile": len(self.devices[0])}

    def is_local(self, slot: Tuple[int, int]) -> bool:
        """Whether this process owns slot ``(data, tile)``."""
        return self.ranks[slot[0]][slot[1]] == self.this_rank

    @property
    def spans_processes(self) -> bool:
        """Whether other processes own slots: a mesh that does spans every
        process of the group (``distributed.global_mesh``), and each must
        make the same calls on it."""
        return any(r != self.this_rank for row in self.ranks for r in row)

    def row(self, i: int) -> Row:
        return Row(self.devices[i], self.ranks[i], self.this_rank)

    @property
    def first(self) -> torch.device:
        """Where gathered results land: the device of the first slot this
        process owns (the mesh's first device when it owns them all)."""
        for devs, ranks in zip(self.devices, self.ranks):
            for d, r in zip(devs, ranks):
                if r == self.this_rank:
                    return d
        raise ValueError(f"rank {self.this_rank} owns no slot of the mesh")


def make_mesh(data: int = 1, tile: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a ``(data, tile)`` mesh from ``devices`` (names or
    ``torch.device``s; repeats allowed), by default every visible CUDA
    device, every slot this process's. ``tile=None`` uses all remaining
    devices. With no CUDA device visible and no ``devices``, it raises: a
    CPU mesh is asked for by name (``devices=["cpu"] * n``)."""
    if devices is None:
        n_cuda = torch.cuda.device_count()
        if n_cuda == 0:
            raise RuntimeError("make_mesh: no CUDA device is visible; pass devices= "
                               "(e.g. ['cpu'] * 4) for a mesh on other devices")
        devices = [torch.device("cuda", i) for i in range(n_cuda)]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if tile is None:
        if n % data != 0:
            raise ValueError(f"{n} devices not divisible by data={data}")
        tile = n // data
    if data * tile > n:
        raise ValueError(f"mesh {data}x{tile} needs {data * tile} devices, have {n}")
    return Mesh(tuple(tuple(devices[i * tile:(i + 1) * tile]) for i in range(data)))


def single_device_mesh() -> Mesh:
    return make_mesh(data=1, tile=1)

"""Device meshes (twin of ``stepth_tpu/parallel/mesh.py``).

A :class:`Mesh` is a ``(data, tile)`` grid of ``torch.device``s: stereo
pairs of a batch shard over ``data``, image rows over ``tile``. The
reference is single-controller — ``shard_map`` runs every shard of a mesh
in one process and ``ppermute``/``psum`` move data between that process's
devices — and so is the port: the per-shard code is a Python loop over the
mesh's devices, and halos and relayed carries move with ``.to(device)``.
The same device may appear more than once, so ``["cuda:0"] * 3`` runs three
real shards (real seams, a real carry relay) on one card, and ``["cpu"] *
8`` is the tests' mesh; distinct cards run the same code.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices[data][tile]``: row ``i`` holds the tile devices of data
    shard ``i``."""

    devices: Tuple[Tuple[torch.device, ...], ...]

    @property
    def shape(self) -> dict:
        return {"data": len(self.devices), "tile": len(self.devices[0])}

    @property
    def first(self) -> torch.device:
        """Where gathered results land: the mesh's first device."""
        return self.devices[0][0]


def make_mesh(data: int = 1, tile: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a ``(data, tile)`` mesh from ``devices`` (names or
    ``torch.device``s; repeats allowed), by default every visible CUDA
    device. ``tile=None`` uses all remaining devices. With no CUDA device
    visible and no ``devices``, it raises: a CPU mesh is asked for by name
    (``devices=["cpu"] * n``)."""
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

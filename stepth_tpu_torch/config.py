"""Frozen configuration dataclasses, field for field those of the reference.

``SubdivisionConfig``, ``RingSearchConfig``, ``MatchConfig``,
``PyramidConfig`` and ``MeshConfig`` copy ``stepth_tpu/config.py``;
``SGMConfig`` copies ``stepth_tpu/match/sgm.py``. The matcher has no learned
weights, so these configs are the whole state a run carries:
:func:`from_dict` rebuilds one from ``dataclasses.asdict`` of a reference
config, so one configuration drives both packages.
"""

from __future__ import annotations

import dataclasses
import math
import typing
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class SubdivisionConfig:
    """Subdivision bounds of the parity path: ``max_splits`` is
    ceil(log2(H·W)) at call time when None."""

    min_splits: int = 16
    max_splits: Optional[int] = None

    def resolved_max(self, height: int, width: int) -> int:
        if self.max_splits is not None:
            return self.max_splits
        return int(math.ceil(math.log2(float(height * width))))


@dataclasses.dataclass(frozen=True)
class RingSearchConfig:
    """Expanding ring-search bound of the parity path: rings 0 …
    ``max_radius`` − 1."""

    max_radius: int = 255


@dataclasses.dataclass(frozen=True)
class MatchConfig:
    """Dense stereo matcher: cost over ``num_disparities`` horizontal shifts,
    aggregated over a ``window`` box, winner-take-all with optional subpixel
    refinement."""

    num_disparities: int = 64
    window: int = 9
    cost: str = "sad"  # "sad" | "ssd" | "census"
    census_window: int = 7
    subpixel: bool = True
    # Left-right consistency check threshold in disparity units; None disables.
    lr_threshold: Optional[float] = 1.0
    # Uniqueness ratio check (best vs. second-best cost); None disables.
    uniqueness: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class PyramidConfig:
    """Coarse-to-fine hierarchy: the coarsest level searches
    ``coarsest_disparities``, every finer level refines ``± refine_radius``
    around the 2×-upsampled estimate in up to ``refine_windows`` base windows
    per (tile_rows × 128-column) tile."""

    levels: int = 4
    refine_radius: int = 2
    coarsest_disparities: int = 32
    refine_windows: int = 16
    # Final (full-resolution) level overrides; None inherits refine_radius /
    # refine_windows.
    refine_radius_final: Optional[int] = None
    refine_windows_final: Optional[int] = None

    @property
    def final_radius(self) -> int:
        return (
            self.refine_radius
            if self.refine_radius_final is None
            else self.refine_radius_final
        )

    @property
    def final_windows(self) -> int:
        return (
            self.refine_windows
            if self.refine_windows_final is None
            else self.refine_windows_final
        )


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh shape for row-tile sharding: ``data`` (batch) × ``tile``
    (image-row tiles)."""

    data: int = 1
    tile: int = 1
    axis_names: Tuple[str, str] = ("data", "tile")


@dataclasses.dataclass(frozen=True)
class SGMConfig:
    """Semi-global aggregation knobs (``directions`` ∈ {2, 4, 8}; ``p1``/``p2``
    per-pixel penalties scaled by ``window²`` when the volume is
    box-aggregated; both must be ≥ 0 on the CUDA kernels). ``volume_dtype``
    is the stored volume's type in the ``sgm-pallas``/``hierarchical-sgm``
    pipeline; ``step_block``/``lane_tile`` retile only the reference's TPU
    grid and are carried for config parity. ``match.sgm`` re-exports it."""

    p1: float = 8.0
    p2: float = 32.0
    directions: int = 4
    volume_dtype: str = "f32"  # "f32" | "bf16"
    step_block: int = 16
    lane_tile: int = 512


DEFAULT_PRECISION: Tuple[int, int, int] = (255 // 7,) * 3


def from_dict(cls, d: dict):
    """Build dataclass ``cls`` from ``dataclasses.asdict`` output (nested
    dataclass fields given as dicts are rebuilt recursively). Unknown keys
    raise, so a config from a newer reference cannot be half-read."""
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"{cls.__name__}: unknown fields {sorted(unknown)}")
    hints = typing.get_type_hints(cls)
    kw = {}
    for name, value in d.items():
        t = hints[name]
        if dataclasses.is_dataclass(t) and isinstance(value, dict):
            value = from_dict(t, value)
        elif isinstance(value, list):
            value = tuple(value)
        kw[name] = value
    return cls(**kw)

"""Model-level API: a configured stereo depth estimator (twin of
``stepth_tpu/models/stereo.py:38-198``).

The fields are the reference's, so one configuration drives both packages,
and the eight backends keep their names: ``"dense"`` is the plain-torch cost
volume matcher, ``"pallas"`` the exhaustive matcher on the port's kernels
(K1, K4, K5, K3), ``"hierarchical"`` the coarse-to-fine pyramid in plain
torch (``match.pyramid``), ``"hierarchical-pallas"`` the pyramid on the
kernels (K1, K2, K3, and K4, K5 with ``lr_check``), ``"hierarchical-sgm"``
the same with the SGM matcher at the coarsest level, ``"sgm"`` the
plain-torch semi-global matcher, ``"sgm-pallas"`` the same on kernels K6–K9
(with K4, K5, K3), and ``"parity"`` the reference's own depth-from-additional
flow (``match.parity``, u8 depth as the disparity).
:meth:`StereoModel.batched` and :meth:`StereoModel.video` are Python loops
over frames; :meth:`StereoModel.sharded` runs six backends row-tile-sharded
over a device mesh (``parallel/``); as in the reference, ``hierarchical``
and ``parity`` have no sharded path.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from stepth_tpu_torch.config import (
    DEFAULT_PRECISION,
    MatchConfig,
    PyramidConfig,
    SGMConfig,
)
from stepth_tpu_torch.match import dense
from stepth_tpu_torch.utils import tracing


@dataclasses.dataclass(frozen=True)
class StereoModel:
    """A configured stereo depth estimator."""

    backend: str = "dense"
    match: MatchConfig = MatchConfig()
    pyramid: PyramidConfig = PyramidConfig()
    sgm: SGMConfig = SGMConfig()  # sgm / sgm-pallas / hierarchical-sgm only
    precision: Tuple[int, int, int] = DEFAULT_PRECISION  # parity backend only
    # hierarchical-pallas / hierarchical-sgm only: run the final refine
    # level's right view and mark LR-inconsistent pixels invalid (then fill
    # them from their scanline neighbours). The other backends take their
    # LR switch from match.lr_threshold.
    lr_check: bool = False

    @tracing.annotate("stepth/call")
    def __call__(self, left, right, device=None) -> dense.MatchResult:
        """Match a rectified pair: gray [H, W] or RGB [H, W, 3] tensors (the
        device is theirs), or arrays (on ``device``, by default ``"cuda"``)."""
        if self.backend == "dense":
            return dense.match_pair(left, right, self.match, device)
        if self.backend == "pallas":
            from stepth_tpu_torch.match import fused_dense

            return fused_dense.match_pair_fused(left, right, self.match, device=device)
        if self.backend in ("hierarchical-pallas", "hierarchical-sgm"):
            from stepth_tpu_torch.match import fused_refine

            return fused_refine.match_hierarchical_fused(
                left, right, self.match, self.pyramid, lr_check=self.lr_check,
                coarse_backend=self._coarse(), device=device, sgm=self.sgm,
            )
        if self.backend == "sgm":
            from stepth_tpu_torch.match import sgm

            return sgm.match_pair_sgm(left, right, self.match, self.sgm, device)
        if self.backend == "sgm-pallas":
            from stepth_tpu_torch.match import fused_sgm

            return fused_sgm.match_pair_sgm_fused(left, right, self.match, self.sgm,
                                                  device=device)
        if self.backend == "hierarchical":
            from stepth_tpu_torch.match import pyramid

            return pyramid.match_hierarchical(left, right, self.match, self.pyramid,
                                              device=device)
        if self.backend == "parity":
            from stepth_tpu_torch.match import parity

            depth = parity.depth_from_additional(
                dense.to_tensor(left, device).to(torch.uint8),
                dense.to_tensor(right, device).to(torch.uint8), self.precision)
            d = depth.to(torch.float32)
            return dense.MatchResult(disparity=d, valid=torch.ones_like(d, dtype=torch.bool),
                                     cost=torch.zeros_like(d))
        raise ValueError(f"unknown backend {self.backend!r}")

    def _coarse(self) -> str:
        return "sgm" if self.backend == "hierarchical-sgm" else "wta"

    def depth_u8(self, left, right, device=None) -> torch.Tensor:
        """Disparity scaled to the reference's u8 depth convention (the
        ``parity`` backend's disparity is that depth already)."""
        res = self(left, right, device)
        if self.backend == "parity":
            return res.disparity.to(torch.uint8)
        return dense.disparity_to_depth_u8(res.disparity, self.match.num_disparities)

    def batched(self):
        """Batch path for independent frames: a callable mapping stacked
        pairs ``[B, H, W]`` (or ``[B, H, W, 3]``) to a stacked
        :class:`MatchResult`. The reference rolls the batch as one
        ``lax.scan``; here it is a loop over frames on the inputs' device."""
        if self.backend == "parity":
            raise NotImplementedError("parity backend is host-side; loop it")

        def run(lefts, rights, device=None) -> dense.MatchResult:
            frames = [self(lefts[b], rights[b], device) for b in range(lefts.shape[0])]
            return dense.MatchResult(*(torch.stack(field) for field in zip(*frames)))

        return run

    def video(self, keyframe_interval: int = 8):
        """Temporally seeded video path: a callable mapping stacked clips
        ``[T, H, W]`` to a stacked :class:`MatchResult`. Non-keyframes skip
        the coarse pyramid and run only the full-resolution refine seeded by
        the previous frame's disparity; every ``keyframe_interval``-th frame
        re-runs the full pyramid (``fused_refine.match_temporal_fused``, with
        the SGM coarse level on ``hierarchical-sgm``)."""
        if self.backend not in ("hierarchical-pallas", "hierarchical-sgm"):
            raise NotImplementedError(
                f"video() needs a hierarchical Pallas backend, got {self.backend!r}"
            )
        from stepth_tpu_torch.match import fused_refine

        @tracing.annotate("stepth/call")
        def run(lefts, rights, device=None) -> dense.MatchResult:
            return fused_refine.match_temporal_fused(
                lefts, rights, self.match, self.pyramid,
                keyframe_interval=keyframe_interval, lr_check=self.lr_check,
                coarse_backend=self._coarse(), device=device, sgm=self.sgm,
            )

        return run

    def sharded(self, mesh):
        """A callable running this model row-tile-sharded over ``mesh``
        (``parallel.mesh.make_mesh``, or ``parallel.distributed.global_mesh``
        for a mesh over several processes, each of which makes the same
        call) on a pair of tensors or arrays; the whole result lands on every
        process's first slot of the mesh (``mesh.first``). ``sgm-pallas`` takes the
        ``exact``/``warmup``/``halo`` keywords of
        ``match_pair_sgm_pallas_sharded``. As in the reference, the
        hierarchical backends run without ``lr_check``: call
        ``parallel.sharded.match_hierarchical_sharded(..., lr_check=True)``
        for the sharded LR check."""
        from stepth_tpu_torch.parallel import sharded

        if self.backend == "dense":
            return lambda l, r: sharded.match_pair_sharded(l, r, self.match, mesh)
        if self.backend == "pallas":
            return lambda l, r: sharded.match_pair_sharded_pallas(l, r, self.match, mesh)
        if self.backend in ("hierarchical-pallas", "hierarchical-sgm"):
            return lambda l, r: sharded.match_hierarchical_sharded(
                l, r, self.match, self.pyramid, mesh, coarse_backend=self._coarse(),
                sgm=self.sgm)
        if self.backend == "sgm":
            from stepth_tpu_torch.parallel import sgm_sharded

            return lambda l, r: sgm_sharded.match_pair_sgm_sharded(l, r, self.match, self.sgm,
                                                                   mesh)
        if self.backend == "sgm-pallas":
            from stepth_tpu_torch.parallel import sgm_pallas_sharded

            return lambda l, r, **kw: sgm_pallas_sharded.match_pair_sgm_pallas_sharded(
                l, r, self.match, self.sgm, mesh, **kw)
        raise NotImplementedError(f"sharded() unsupported for {self.backend}")


def flagship(num_disparities: int = 128) -> StereoModel:
    """The reference's benchmark configuration: the exhaustive matcher
    (``pallas`` backend), SAD, LR check."""
    return StereoModel(
        backend="pallas",
        match=MatchConfig(
            num_disparities=num_disparities, window=9, cost="sad", lr_threshold=1.0
        ),
    )

"""Model-level API: a configured stereo depth estimator (twin of
``stepth_tpu/models/stereo.py:38-110``).

The fields are the reference's, so one configuration drives both packages.
Backend ``"hierarchical-pallas"`` keeps its name: it runs the coarse-to-fine
pyramid through the port's kernels K1–K3. Every other backend names the
ROADMAP item that ports it.
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

_NOT_PORTED = {
    "dense": "ROADMAP Queue 1 item 2 (match/dense.py twin: match_pair)",
    "pallas": "ROADMAP Queue 1 item 4 (match_pair_pallas, needs K5)",
    "hierarchical": "ROADMAP Queue 1 item 8 (XLA-only backends)",
    "hierarchical-sgm": "ROADMAP Queue 1 item 7 (SGM, K6-K9)",
    "sgm": "ROADMAP Queue 1 item 7 (SGM)",
    "sgm-pallas": "ROADMAP Queue 1 item 7 (SGM, K6-K9)",
    "parity": "ROADMAP Queue 1 item 9 (parity)",
}


@dataclasses.dataclass(frozen=True)
class StereoModel:
    """A configured stereo depth estimator."""

    backend: str = "dense"
    match: MatchConfig = MatchConfig()
    pyramid: PyramidConfig = PyramidConfig()
    sgm: SGMConfig = SGMConfig()  # sgm / sgm-pallas / hierarchical-sgm only
    precision: Tuple[int, int, int] = DEFAULT_PRECISION  # parity backend only
    # hierarchical backends: flag LR-inconsistent pixels invalid (not ported)
    lr_check: bool = False

    def __call__(self, left, right, device=None) -> dense.MatchResult:
        """Match a rectified pair: gray [H, W] or RGB [H, W, 3] tensors (the
        device is theirs), or arrays with an explicit ``device``."""
        if self.backend == "hierarchical-pallas":
            from stepth_tpu_torch.match import fused_refine

            return fused_refine.match_hierarchical_fused(
                left, right, self.match, self.pyramid,
                lr_check=self.lr_check, device=device,
            )
        if self.backend in _NOT_PORTED:
            raise NotImplementedError(
                f"backend {self.backend!r} is not ported yet: {_NOT_PORTED[self.backend]}"
            )
        raise ValueError(f"unknown backend {self.backend!r}")

    def depth_u8(self, left, right, device=None) -> torch.Tensor:
        """Disparity scaled to the reference's u8 depth convention."""
        res = self(left, right, device)
        return dense.disparity_to_depth_u8(res.disparity, self.match.num_disparities)

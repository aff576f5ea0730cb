"""Multi-view geometry (twin of ``stepth_tpu/fusion``). Ported so far:
``geometry`` (SE(3), projection, disparity to depth and points)."""

from stepth_tpu_torch.fusion import geometry

__all__ = ["geometry"]

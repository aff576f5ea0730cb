"""Multi-view geometry and mapping (twin of ``stepth_tpu/fusion``): SE(3)
geometry, two-view epipolar geometry, multi-keyframe depth fusion,
pose-graph optimisation, Schur-complement bundle adjustment (sharded over a
mesh) and its resumable, checkpointed solve."""

from stepth_tpu_torch.fusion import ba, depthfusion, epipolar, geometry, posegraph, resumable

__all__ = ["ba", "depthfusion", "epipolar", "geometry", "posegraph", "resumable"]

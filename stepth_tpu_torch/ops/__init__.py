"""Image, depth and rig operations (twin of ``stepth_tpu/ops``): kernel K11
and rectification, photometric gain, masks, resampling, depth utilities,
k-means depth zones, adjustments and temporal ops."""

from stepth_tpu_torch.ops import (adjust, depth, fused_remap, kmeans, mask, photometric,
                                  rectify, resize, temporal)

__all__ = ["adjust", "depth", "fused_remap", "kmeans", "mask", "photometric", "rectify",
           "resize", "temporal"]

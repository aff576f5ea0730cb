"""Containers, I/O and the prefetch loader (twin of ``stepth_tpu/core``)."""

from stepth_tpu_torch.core import io
from stepth_tpu_torch.core.frame import MASK_FALSE, MASK_TRUE, DepthFrame, MaskFrame

__all__ = ["io", "DepthFrame", "MaskFrame", "MASK_TRUE", "MASK_FALSE"]

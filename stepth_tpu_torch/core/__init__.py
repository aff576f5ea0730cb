"""Containers and I/O (twin of ``stepth_tpu/core``). Ported so far: ``io``."""

from stepth_tpu_torch.core import io

__all__ = ["io"]

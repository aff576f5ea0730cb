"""Model-level API."""

from stepth_tpu_torch.models.stereo import StereoModel

__all__ = ["StereoModel"]

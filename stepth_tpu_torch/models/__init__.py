"""Model-level API."""

from stepth_tpu_torch.models.stereo import StereoModel, flagship

__all__ = ["StereoModel", "flagship"]

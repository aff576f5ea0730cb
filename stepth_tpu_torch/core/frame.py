"""Immutable frame containers (twin of ``stepth_tpu/core/frame.py:21-288``).

``DepthFrame`` (an RGBA image and a Luma8 depth plane) and ``MaskFrame`` (an
RGBA image and a Luma8 mask) are frozen dataclasses of u8 tensors on one
device; every method that changes a plane returns a new frame
(``dataclasses.replace``). The containers carry no compute: the methods are
thin wrappers over ``ops`` and ``match``, imported inside them (``ops/mask``
takes :data:`MASK_TRUE`/:data:`MASK_FALSE` from here). Planes handed to a
frame go to the frame's device; constructors put an array on ``device``,
the card by default (``match.dense.default_device``).

The reference's quirks are kept: ``load_mask`` silently resizes a mask of
another size (Q6), and ``MaskFrame.save`` writes the image, not the mask
(Q7).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from stepth_tpu_torch.core import io as _io

MASK_TRUE: int = 255
MASK_FALSE: int = 0


def _u8(x, device=None) -> torch.Tensor:
    """``x`` as a u8 tensor: on ``device`` when one is named; otherwise a
    tensor keeps its device and an array goes to the card."""
    from stepth_tpu_torch.match.dense import default_device

    if isinstance(x, torch.Tensor):
        return x.to(device=x.device if device is None else device, dtype=torch.uint8)
    return torch.as_tensor(np.array(x, dtype=np.uint8), device=default_device(device))


def _rgba(image, device) -> torch.Tensor:
    """u8 [H, W, 4] from an RGB or RGBA image (devices as :func:`_u8`)."""
    image = _u8(image, device)
    if image.ndim != 3 or image.shape[-1] not in (3, 4):
        raise ValueError(f"expected u8[H,W,3|4] image, got {tuple(image.shape)}")
    if image.shape[-1] == 3:
        alpha = torch.full(image.shape[:2] + (1,), 255, dtype=torch.uint8, device=image.device)
        image = torch.cat([image, alpha], dim=-1)
    return image


def _hw(arr) -> Tuple[int, int]:
    return int(arr.shape[0]), int(arr.shape[1])


@dataclasses.dataclass(frozen=True)
class DepthFrame:
    """RGBA image + Luma8 depth pair."""

    image: torch.Tensor  # u8[H, W, 4]
    depth: torch.Tensor  # u8[H, W]

    # -- constructors -------------------------------------------------------
    @classmethod
    def open(cls, path, device=None) -> "DepthFrame":
        """Decode ``path`` (zero depth) onto ``device``, the card by default."""
        return cls.from_array(_io.open_rgba(path), device)

    @classmethod
    def from_array(cls, image, device=None) -> "DepthFrame":
        """An RGB or RGBA image with zero depth. A tensor keeps its device
        unless ``device`` names another; an array goes to ``device``, the
        card by default."""
        image = _rgba(image, device)
        return cls(image=image, depth=torch.zeros(image.shape[:2], dtype=torch.uint8,
                                                  device=image.device))

    def replace(self, **changes) -> "DepthFrame":
        return dataclasses.replace(self, **changes)

    # -- geometry ------------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.image.device

    @property
    def width(self) -> int:
        return int(self.image.shape[1])

    @property
    def height(self) -> int:
        return int(self.image.shape[0])

    @property
    def dimensions(self) -> Tuple[int, int]:
        """(height, width)."""
        return _hw(self.image)

    # -- depth loading -------------------------------------------------------
    def with_depth(self, depth) -> "DepthFrame":
        """Strict size check (the reference's ``load_depth``); the plane goes
        to the frame's device."""
        if _hw(depth) != self.dimensions:
            raise ValueError("Sizes don't match")
        return self.replace(depth=_u8(depth, self.device))

    def open_depth(self, path) -> "DepthFrame":
        return self.with_depth(_io.open_luma(path))

    def open_depth_from_additional(self, path, precision,
                                   method: str = "parity") -> "DepthFrame":
        return self.load_depth_from_additional(_io.open_rgb(path), precision, method)

    def load_depth_from_additional(self, add_image, precision,
                                   method: str = "parity") -> "DepthFrame":
        """The core pipeline. ``method``: ``"parity"`` (the default: the
        reference's own flow, ``match.parity``, on the frame's device),
        ``"native"`` (the C++ host engine, :mod:`stepth_tpu_torch.native`:
        the same output, computed on the host) or any
        :class:`stepth_tpu_torch.models.StereoModel` backend name (disparity
        scaled to u8 depth). The depth goes to the frame's device."""
        main_rgb = self.image[..., :3]
        add_rgb = _u8(add_image, self.device)[..., :3]
        if method == "native":
            from stepth_tpu_torch import native

            depth = native.depth_from_additional(main_rgb, add_rgb, precision)
        elif method == "parity":
            from stepth_tpu_torch.match import parity

            depth = parity.depth_from_additional(main_rgb, add_rgb, precision)
        else:
            from stepth_tpu_torch.models import StereoModel

            depth = StereoModel(backend=method).depth_u8(main_rgb, add_rgb)
        return self.with_depth(depth)

    # -- depth utilities ------------------------------------------------------
    def highlight_depth(self) -> torch.Tensor:
        """RGBA image with rgb scaled by depth/255·2."""
        from stepth_tpu_torch.ops import depth as depth_ops

        return depth_ops.highlight_depth(self.image, self.depth)

    def invert_depth(self) -> "DepthFrame":
        from stepth_tpu_torch.ops import depth as depth_ops

        return self.replace(depth=depth_ops.invert(self.depth))

    def depth_split(self, zones: int):
        """[(min, max)] per k-means depth zone."""
        from stepth_tpu_torch.ops import kmeans

        return kmeans.depth_split(self.depth, zones)

    def slice(self, lo: Optional[int], hi: Optional[int]) -> "MaskFrame":
        from stepth_tpu_torch.ops import depth as depth_ops

        return MaskFrame(image=self.image, mask=depth_ops.slice_mask(self.depth, lo, hi))

    def select_foreground(self) -> "MaskFrame":
        """The mask of the lower-valued of two k-means depth zones (the
        first of ``depth_split(2)``)."""
        lo, hi = self.depth_split(2)[0]
        return self.slice(lo, hi)

    def resize(self, height: int, width: int) -> "DepthFrame":
        """Aspect-preserving Gaussian resize of both planes."""
        from stepth_tpu_torch.ops import resize as resize_ops

        return DepthFrame(image=resize_ops.resize_u8(self.image, height, width),
                          depth=resize_ops.resize_u8(self.depth, height, width))

    # -- I/O -----------------------------------------------------------------
    def save_depth(self, path) -> None:
        _io.save(path, self.depth)

    def save_image(self, path) -> None:
        _io.save(path, self.image)


@dataclasses.dataclass(frozen=True)
class MaskFrame:
    """RGBA image + Luma8 mask (255 true, 0 false)."""

    image: torch.Tensor  # u8[H, W, 4]
    mask: torch.Tensor  # u8[H, W]

    # -- constructors ----------------------------------------------------------
    @classmethod
    def open(cls, path, device=None) -> "MaskFrame":
        return cls.from_array(_io.open_rgba(path), device)

    @classmethod
    def from_array(cls, image, device=None) -> "MaskFrame":
        """An RGB or RGBA image with an all-true mask (devices as in
        :meth:`DepthFrame.from_array`)."""
        image = _rgba(image, device)
        return cls(image=image, mask=torch.full(image.shape[:2], MASK_TRUE, dtype=torch.uint8,
                                                device=image.device))

    def replace(self, **changes) -> "MaskFrame":
        return dataclasses.replace(self, **changes)

    # -- geometry --------------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.image.device

    @property
    def width(self) -> int:
        return int(self.image.shape[1])

    @property
    def height(self) -> int:
        return int(self.image.shape[0])

    @property
    def dimensions(self) -> Tuple[int, int]:
        return _hw(self.image)

    # -- mask loading (lenient: quirk Q6) ----------------------------------------
    def load_mask(self, mask, rebinarize: bool = False) -> "MaskFrame":
        """A mask of another size is Gaussian-resized to the frame's (quirk
        Q6); ``rebinarize`` (off by default) re-thresholds it at 128."""
        from stepth_tpu_torch.ops import mask as mask_ops

        return self.replace(mask=mask_ops.conform(_u8(mask, self.device), self.dimensions,
                                                  rebinarize))

    def load_mask_from_file(self, path, rebinarize: bool = False) -> "MaskFrame":
        return self.load_mask(_io.open_luma(path), rebinarize)

    # -- mask algebra ------------------------------------------------------------
    def _conformed(self, other: "MaskFrame") -> torch.Tensor:
        from stepth_tpu_torch.ops import mask as mask_ops

        return mask_ops.conform(_u8(other.mask, self.device), self.dimensions)

    def mask_and(self, other: "MaskFrame") -> "MaskFrame":
        from stepth_tpu_torch.ops import mask as mask_ops

        return self.replace(mask=mask_ops.mask_and(self.mask, self._conformed(other)))

    def mask_or(self, other: "MaskFrame") -> "MaskFrame":
        from stepth_tpu_torch.ops import mask as mask_ops

        return self.replace(mask=mask_ops.mask_or(self.mask, self._conformed(other)))

    def mask_not(self) -> "MaskFrame":
        from stepth_tpu_torch.ops import mask as mask_ops

        return self.replace(mask=mask_ops.mask_not(self.mask))

    def mask_copy(self, other: "MaskFrame") -> "MaskFrame":
        return self.load_mask(other.mask)

    def mask_reset(self) -> "MaskFrame":
        from stepth_tpu_torch.ops import mask as mask_ops

        return self.replace(mask=mask_ops.reset(self.dimensions, self.device))

    def apply_mask(self) -> "MaskFrame":
        from stepth_tpu_torch.ops import mask as mask_ops

        return self.replace(image=mask_ops.apply(self.image, self.mask))

    def highlight_mask(self) -> torch.Tensor:
        from stepth_tpu_torch.ops import mask as mask_ops

        return mask_ops.highlight(self.image, self.mask)

    # -- masked image adjustments --------------------------------------------
    def image_replace(self, other: "MaskFrame", start_yx=(0, 0)) -> "MaskFrame":
        from stepth_tpu_torch.ops import mask as mask_ops

        return self.replace(image=mask_ops.image_replace(
            self.image, self.mask, _u8(other.image, self.device), start_yx))

    def _masked(self, out: torch.Tensor) -> "MaskFrame":
        """``out`` where the mask is true, the image elsewhere."""
        from stepth_tpu_torch.ops import mask as mask_ops

        return self.replace(image=mask_ops.image_replace(self.image, self.mask, out, (0, 0)))

    def image_brightness(self, value: int) -> "MaskFrame":
        from stepth_tpu_torch.ops import adjust

        return self._masked(adjust.brighten(self.image, value))

    def image_contrast(self, value: float) -> "MaskFrame":
        from stepth_tpu_torch.ops import adjust

        return self._masked(adjust.contrast(self.image, float(value)))

    def image_sharpness(self, value: float) -> "MaskFrame":
        from stepth_tpu_torch.ops import adjust

        return self._masked(adjust.unsharpen(self.image, float(value), 20))

    def image_blur(self, value: float) -> "MaskFrame":
        from stepth_tpu_torch.ops import adjust

        return self._masked(adjust.blur(self.image, float(value)))

    def resize(self, height: int, width: int) -> "MaskFrame":
        from stepth_tpu_torch.ops import resize as resize_ops

        return MaskFrame(image=resize_ops.resize_u8(self.image, height, width),
                         mask=resize_ops.resize_u8(self.mask, height, width))

    # -- I/O (quirk Q7: save() writes the image, not the mask) -------------------
    def save(self, path) -> None:
        _io.save(path, self.image)

    def save_mask(self, path) -> None:
        _io.save(path, self.mask)

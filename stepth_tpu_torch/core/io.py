"""Image and point-cloud I/O at the array boundary (the port's own copy of
``stepth_tpu/core/io.py``).

PIL decodes and encodes; everything here is NumPy (RGB u8[H,W,3], RGBA
u8[H,W,4], luma u8[H,W]). The writers also take torch tensors on any device
(copied to the host first), without importing torch.
"""

from __future__ import annotations

import os

import numpy as np

try:  # PIL is the edge decoder; arrays everywhere else.
    from PIL import Image as _PILImage

    _HAS_PIL = True
except ImportError:  # pragma: no cover - PIL is part of the environment
    _HAS_PIL = False


class ImageIOError(ValueError):
    """Raised on decode and size failures."""


def _require_pil() -> None:
    if not _HAS_PIL:  # pragma: no cover
        raise ImageIOError("PIL is unavailable; install pillow for image I/O")


def _host(x) -> np.ndarray:
    """``x`` as a NumPy array; a torch tensor is detached and copied to the
    host first."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _open(path, mode: str) -> np.ndarray:
    _require_pil()
    try:
        with _PILImage.open(path) as im:
            return np.asarray(im.convert(mode), dtype=np.uint8)
    except (OSError, ValueError) as e:
        raise ImageIOError(f"Failed to open image: {path}") from e


def open_rgba(path: str | os.PathLike) -> np.ndarray:
    """Decode to RGBA u8[H,W,4]."""
    return _open(path, "RGBA")


def open_rgb(path: str | os.PathLike) -> np.ndarray:
    """Decode to RGB u8[H,W,3]."""
    return _open(path, "RGB")


def open_luma(path: str | os.PathLike) -> np.ndarray:
    """Decode to luma u8[H,W] by Rec.709 weights (:func:`rgb_to_luma`); PIL's
    ``convert("L")`` (Rec.601) only for images that are gray already."""
    _require_pil()
    try:
        with _PILImage.open(path) as im:
            if im.mode in ("L", "I;16", "I"):
                return np.asarray(im.convert("L"), dtype=np.uint8)
            rgb = np.asarray(im.convert("RGB"), dtype=np.uint8)
    except (OSError, ValueError) as e:
        raise ImageIOError(f"Failed to open image: {path}") from e
    return rgb_to_luma(rgb)


def rgb_to_luma(rgb) -> np.ndarray:
    """trunc(0.2126 r + 0.7152 g + 0.0722 b) in f32."""
    rgb = _host(rgb)
    w = np.array([0.2126, 0.7152, 0.0722], dtype=np.float32)
    return (rgb[..., :3].astype(np.float32) * w).sum(axis=-1).astype(np.uint8)


def rgba_to_rgb(rgba) -> np.ndarray:
    """Drop alpha."""
    return np.ascontiguousarray(_host(rgba)[..., :3])


def rgb_to_rgba(rgb) -> np.ndarray:
    """Append opaque alpha."""
    rgb = _host(rgb)
    alpha = np.full(rgb.shape[:-1] + (1,), 255, dtype=np.uint8)
    return np.concatenate([rgb, alpha], axis=-1)


def save(path: str | os.PathLike, array) -> None:
    """Encode a u8 array (HW → L, HW3 → RGB, HW4 → RGBA; RGBA is saved as
    RGB for JPEG targets)."""
    _require_pil()
    arr = _host(array).astype(np.uint8, copy=False)
    if arr.ndim == 2:
        im = _PILImage.fromarray(arr, mode="L")
    elif arr.ndim == 3 and arr.shape[-1] == 3:
        im = _PILImage.fromarray(arr, mode="RGB")
    elif arr.ndim == 3 and arr.shape[-1] == 4:
        im = _PILImage.fromarray(arr, mode="RGBA")
    else:
        raise ImageIOError(f"Unsupported array shape for save: {arr.shape}")
    ext = os.path.splitext(str(path))[1].lower()
    if ext in (".jpg", ".jpeg") and im.mode == "RGBA":
        im = im.convert("RGB")
    im.save(path)


def save_ply(path, points, colors=None, valid=None) -> int:
    """Write a point cloud as binary little-endian PLY.

    ``points``: [..., 3] (flattened); ``colors``: optional [..., 3] u8 (or
    float 0–255, clipped); ``valid``: optional boolean mask over the leading
    shape. Invalid and non-finite points are dropped. Returns the number of
    points written."""
    pts = _host(points).astype(np.float32).reshape(-1, 3)
    keep = np.isfinite(pts).all(axis=1)
    if valid is not None:
        keep &= _host(valid).astype(bool).reshape(-1)
    col = None
    if colors is not None:
        col = _host(colors).reshape(-1, 3)
        if col.dtype != np.uint8:
            col = np.clip(col, 0, 255).astype(np.uint8)
        col = col[keep]
    pts = pts[keep]
    n = int(pts.shape[0])
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if col is not None:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    header.append("end_header")
    if col is not None:
        rec = np.zeros(n, dtype=[("xyz", np.float32, 3), ("rgb", np.uint8, 3)])
        rec["xyz"] = pts.astype("<f4")
        rec["rgb"] = col
        body = rec.tobytes()
    else:
        body = pts.astype("<f4").tobytes()
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(body)
    return n

"""NumPy resampler (oracle twin of ``stepth_tpu_torch.ops.resize``; twin of
``stepth_tpu/oracle/resize.py``).

Shares the host-side Q15 weight tables with the torch op (deterministic
integer data computed in f64) but accumulates independently in NumPy
int64, so a test asserting oracle == torch exercises the device arithmetic
end to end.
"""

from __future__ import annotations

import numpy as np

from stepth_tpu_torch.ops.resize import _Q, _pass_weights, resize_dimensions


def _resample_axis0_np(img: np.ndarray, idx: np.ndarray, wq: np.ndarray) -> np.ndarray:
    acc = np.zeros((idx.shape[0],) + img.shape[1:], dtype=np.int64)
    for t in range(idx.shape[1]):
        w = wq[:, t].reshape((-1,) + (1,) * (img.ndim - 1)).astype(np.int64)
        acc += w * img[idx[:, t]]
    return np.clip(acc >> _Q, 0, 255)


def resample_exact_np(
    img: np.ndarray,
    out_h: int,
    out_w: int,
    filter_name: str = "gaussian",
    sigma: float | None = None,
) -> np.ndarray:
    h, w = int(img.shape[0]), int(img.shape[1])
    vidx, vw = _pass_weights(h, out_h, filter_name, sigma)
    hidx, hw_ = _pass_weights(w, out_w, filter_name, sigma)
    x = np.asarray(img).astype(np.int64)
    x = _resample_axis0_np(x, vidx, vw)
    x = np.swapaxes(x, 0, 1)
    x = _resample_axis0_np(x, hidx, hw_)
    x = np.swapaxes(x, 0, 1)
    return x.astype(np.uint8)


def resize_u8_np(img: np.ndarray, height: int, width: int, filter_name="gaussian"):
    h, w = int(img.shape[0]), int(img.shape[1])
    tw, th = resize_dimensions(w, h, width, height)
    return resample_exact_np(img, th, tw, filter_name)


def blur_u8_np(img: np.ndarray, sigma: float) -> np.ndarray:
    sigma = 1.0 if sigma <= 0.0 else float(sigma)
    return resample_exact_np(img, int(img.shape[0]), int(img.shape[1]), sigma=sigma)

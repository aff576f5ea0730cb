"""Accuracy metrics (twin of ``stepth_tpu/utils/metrics.py``).

The reference computes them in numpy on the host, and so does the port:
each function takes tensors on any device, or arrays, and returns the same
Python floats as the reference on the same values."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _host(x, dtype=None) -> np.ndarray:
    """``x`` (a tensor on any device, or an array) as a numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=dtype)


def end_point_error(disp, disp_gt, valid=None) -> Dict[str, float]:
    """Disparity end-point-error stats against ground truth: mean EPE, the
    fractions off by more than 1 and 3 px, and the density of ``valid``."""
    d = _host(disp, np.float64)
    g = _host(disp_gt, np.float64)
    m = np.ones(d.shape, bool) if valid is None else _host(valid, bool)
    err = np.abs(d - g)[m]
    if err.size == 0:
        return {"epe": float("nan"), "bad1": float("nan"), "bad3": float("nan"),
                "density": 0.0}
    return {
        "epe": float(err.mean()),
        "bad1": float((err > 1.0).mean()),
        "bad3": float((err > 3.0).mean()),
        "density": float(m.mean()),
    }


def depth_agreement(depth_a, depth_b) -> Dict[str, float]:
    """u8 depth-map agreement: exact-match fraction, mean |Δ|, max |Δ|."""
    a = _host(depth_a, np.int32)
    b = _host(depth_b, np.int32)
    diff = np.abs(a - b)
    return {
        "exact": float((diff == 0).mean()),
        "mean_abs": float(diff.mean()),
        "max_abs": int(diff.max()),
    }


def ate_rmse(poses_a, poses_b) -> float:
    """Absolute trajectory error (RMSE of the translations) between two pose
    arrays [N, 6] in the same gauge."""
    ta = _host(poses_a)[:, 3:]
    tb = _host(poses_b)[:, 3:]
    return float(np.sqrt(((ta - tb) ** 2).sum(axis=1).mean()))


def masked_fraction(mask, true_value: int = 255) -> float:
    return float((_host(mask) == true_value).mean())

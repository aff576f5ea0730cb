"""The reference of the semi-global matcher (``sgm-pallas``), in plain torch.

The box-aggregated cost volume ``[D, H, W]``; the path costs of each
direction (Hirschmüller 2008)::

    L(p, d) = C(p, d) − min L(p−r) + min(L(p−r, d), L(p−r, d±1) + P1, min L(p−r) + P2)

summed in the order →x, ←x, (↘ ↙ ↗ ↖,) ↓y, ↑y, every partial sum stored as
f32; then the first-minimum WTA with parabolic subpixel and the right view
``costR(x, d) = cost(x + d, d)``, the LR check, the scanline fill and the
3×3 median. ``P1``, ``P2`` are per pixel and scaled by ``window²``.

With a ``record`` list, each step appends the launch the program's kernel
path makes for it (``roofline.launch``).
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F

from portbench import roofline
from portbench.reference import common

_HORIZONTAL = ((2, False, 0), (2, True, 0))
_DIAGONALS = ((1, False, 1), (1, False, -1), (1, True, 1), (1, True, -1))
_VERTICAL = ((1, False, 0), (1, True, 0))
_FUSED_MAX_D = 128  # up to here the program fuses the last direction with the WTA


def directions(n: int):
    """``(axis, reverse, shift)`` of each direction, in summation order."""
    if n not in (2, 4, 8):
        raise ValueError(f"directions must be 2, 4 or 8, got {n}")
    return _HORIZONTAL + (_DIAGONALS if n == 8 else ()) + (_VERTICAL if n >= 4 else ())


def step(carry, c, shift: int, p1: float, p2: float):
    """One recurrence step on ``[T, D]``: the carry displaced by ``shift``
    along T (zero-filled), then ``c + min(...) − min L``."""
    if shift > 0:
        carry = F.pad(carry, (0, 0, shift, 0))[:-shift]
    elif shift < 0:
        carry = F.pad(carry, (0, 0, 0, -shift))[-shift:]
    min_l = carry.amin(dim=-1, keepdim=True)
    padded = F.pad(carry, (1, 1), value=float("inf"))
    cand = torch.minimum(carry, torch.minimum(padded[:, :-2] + p1, padded[:, 2:] + p1))
    cand = torch.minimum(cand, min_l + p2)
    return c + cand - min_l


def scan(vol, acc, p1, p2, axis: int, reverse: bool, shift: int):
    """``acc + L`` of one direction over ``vol`` [D, H, W] (``L`` when
    ``acc`` is None), a new f32 volume."""
    n = vol.shape[axis]
    out = torch.empty_like(vol)
    carry = torch.zeros((vol.shape[3 - axis], vol.shape[0]), dtype=torch.float32,
                        device=vol.device)
    for s in (range(n - 1, -1, -1) if reverse else range(n)):
        carry = step(carry, vol.select(axis, s).T, shift, p1, p2)
        L = carry.T
        out.select(axis, s).copy_(L if acc is None else acc.select(axis, s) + L)
    return out


def match_frame(left, right, cfg: dict, record: Optional[list] = None):
    """One frame on f32 RGB [H, W, 3]: ``(disparity, valid)``."""
    m, sg = cfg["match"], cfg["sgm"]
    lg, rg = common.grayscale(left), common.grayscale(right)
    h, w = lg.shape
    D = m["num_disparities"]
    planes = common.census_pair(lg, rg, m["census_window"]) if m["cost"] == "census" else None
    vol = torch.empty((D, h, w), dtype=torch.float32, device=lg.device)
    for d in range(D):
        vol[d] = common.box_cost(lg, rg, planes, m, d, lambda x: x)
    scale = float(m["window"] ** 2) if m["window"] > 1 else 1.0
    p1, p2 = sg["p1"] * scale, sg["p2"] * scale
    acc = None
    for axis, reverse, shift in directions(sg["directions"]):
        acc = scan(vol, acc, p1, p2, axis, reverse, shift)
    wta = common.Wta((h, w), lg.device)
    for d in range(D):
        wta.update(acc[d], d)
    disp, disp_r = wta.result(D)
    if record is not None:
        _record(record, m, sg, h, w, D)
    return common.epilogue(disp, disp_r, m["lr_threshold"], D)


def _record(record, m, sg, h, w, D):
    """The volume, one scan per direction but the last, the last scan with
    the WTA fused in, then the epilogue."""
    V = D * h * w
    P = 1 if m["cost"] != "census" else -(-(m["census_window"] ** 2 - 1) // 32)
    record.append(roofline.launch("sgm_volume_kernel", 8 * P * h * w + 4 * V,
                                  V * roofline.cost_ops(m["cost"], m["window"], P)))
    for i in range(sg["directions"] - 1):  # the first has no running sum to read
        record.append(roofline.launch("sgm_scan_kernel", (8 if i == 0 else 12) * V, 8 * V))
    record += [roofline.launch("sgm_scan_wta_kernel", 8 * V + 20 * h * w, 11 * V),
               roofline.launch("lr_check_kernel", 9 * h * w, 12 * h * w),
               roofline.launch("fill_invalid_kernel", 9 * h * w, 4 * h * w),
               roofline.launch("median3_kernel", 8 * h * w, 38 * h * w)]


def check_config(cfg: dict) -> None:
    """Raise on what this reference does not follow."""
    m, sg = cfg["match"], cfg["sgm"]
    if cfg["backend"] != "sgm-pallas" or sg["volume_dtype"] != "f32":
        raise ValueError("sgm reference: needs backend sgm-pallas with an f32 volume")
    if m["uniqueness"] is not None or not m["subpixel"] or m["lr_threshold"] is None:
        raise ValueError("sgm reference: needs subpixel, an LR threshold, no uniqueness")
    if sg["directions"] not in (4, 8) or m["num_disparities"] > _FUSED_MAX_D:
        raise ValueError("sgm reference: follows the fused path (4 or 8 directions, D ≤ 128)")


def run_call(lefts, rights, cfg: dict, entry: dict, precision: str = "f32",
             record: Optional[List[list]] = None):
    """The outputs of one served call on f32 RGB frames [T, H, W, 3]: a
    ``(disparity, valid)`` per frame, each frame on its own."""
    check_config(cfg)
    if precision != "f32":
        raise ValueError("sgm reference: the control is the program's own bf16 volume")
    outs = []
    for t in range(lefts.shape[0]):
        rec = None if record is None else []
        outs.append(match_frame(lefts[t], rights[t], cfg, rec))
        if record is not None:
            record.append(rec)
    return outs

"""The reference of the semi-global matcher past 256 disparities:
``sgm-pallas`` with 8 directions and ``256 < D ≤ 512``.

The arithmetic is ``sgm.match_frame``'s, which has no bound on D: the
box-aggregated census cost volume, the path costs of every direction
summed in ``sgm.directions`` order with ``sgm.scan`` (every partial sum
stored as f32), the first-minimum WTA with parabolic subpixel and the
right view, then the LR check, the scanline fill and the 3×3 median. What
differs from the references below 256 is the program's launches, which
``record`` lists: the census planes, the volume, every direction scanned
and stored by the staged scan kernel on its deep tiling (each inside the
program's ``stepth/sgm/deep`` span, marked ``span`` in the record), then
the WTA from the stored sum (``sgm_wta_kernel``) and the epilogue.
"""

from __future__ import annotations

from typing import List, Optional

from portbench import roofline
from portbench.reference import sgm

_MIN_D, _MAX_D = 256, 512  # the program's deep tiling takes 256 < D ≤ 512
DEEP_SPAN = "stepth/sgm/deep"


def _record(record, m, sg, h, w):
    """The census planes, the volume, one scan per direction (the first
    reads no running sum: vol read, out written; the others read acc too),
    the WTA from the stored sum (the sum read once, four f32 maps written),
    then the epilogue."""
    V = m["num_disparities"] * h * w
    P = -(-(m["census_window"] ** 2 - 1) // 32)
    record.append(roofline.launch("census_pair_kernel", 2 * (4 + 4 * P) * h * w, 0))
    record.append(roofline.launch("sgm_volume_kernel", 8 * P * h * w + 4 * V,
                                  V * roofline.cost_ops(m["cost"], m["window"], P)))
    for i in range(sg["directions"]):
        record.append(dict(roofline.launch("sgm_scan_kernel", (8 if i == 0 else 12) * V, 8 * V),
                           span=DEEP_SPAN))
    record += [roofline.launch("sgm_wta_kernel", 4 * V + 16 * h * w, 3 * V),
               roofline.launch("lr_check_kernel", 9 * h * w, 12 * h * w),
               roofline.launch("fill_invalid_kernel", 9 * h * w, 4 * h * w),
               roofline.launch("median3_kernel", 8 * h * w, 38 * h * w)]


def check_config(cfg: dict) -> None:
    """Raise on what this reference does not follow."""
    m, sg = cfg["match"], cfg["sgm"]
    if cfg["backend"] != "sgm-pallas" or sg["volume_dtype"] != "f32":
        raise ValueError("sgm_deep reference: needs backend sgm-pallas with an f32 volume")
    if m["cost"] != "census":
        raise ValueError("sgm_deep reference: needs the census cost")
    if m["uniqueness"] is not None or not m["subpixel"] or m["lr_threshold"] is None:
        raise ValueError("sgm_deep reference: needs subpixel, an LR threshold, no uniqueness")
    if sg["directions"] != 8 or not _MIN_D < m["num_disparities"] <= _MAX_D:
        raise ValueError("sgm_deep reference: follows the deep stored-sum path "
                         f"(8 directions, {_MIN_D} < D ≤ {_MAX_D})")


def run_call(lefts, rights, cfg: dict, entry: dict, precision: str = "f32",
             record: Optional[List[list]] = None):
    """The outputs of one served call on f32 RGB frames [T, H, W, 3]: a
    ``(disparity, valid)`` per frame, each frame on its own."""
    check_config(cfg)
    if precision != "f32":
        raise ValueError("sgm_deep reference: the control is the program's own bf16 volume")
    outs = []
    for t in range(lefts.shape[0]):
        outs.append(sgm.match_frame(lefts[t], rights[t], cfg))
        if record is not None:
            rec = []
            _record(rec, cfg["match"], cfg["sgm"], *lefts.shape[1:3])
            record.append(rec)
    return outs

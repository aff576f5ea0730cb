"""The reference of the semi-global matcher past the fused WTA's range:
``sgm-pallas`` with 8 directions and ``128 < D ≤ 256``.

The arithmetic is ``sgm.match_frame``'s: the box-aggregated cost volume,
the path costs of every direction summed in ``sgm.directions`` order with
``sgm.scan`` (every partial sum stored as f32), the first-minimum WTA with
parabolic subpixel and the right view, then the LR check, the scanline
fill and the 3×3 median. With an f32 volume the WTA over the stored sum
gives the same bits as a WTA fused into the last scan; what differs is
the program's launches, which ``record`` lists: every direction scanned
and stored, then the WTA from the stored sum (``sgm_wta_kernel``).
"""

from __future__ import annotations

from typing import List, Optional

from portbench import roofline
from portbench.reference import sgm

_MAX_D = 256  # the program's scans take D up to here


def _record(record, m, sg, h, w):
    """The volume, one scan per direction, the WTA from the stored sum (the
    sum read once, four f32 maps written), then the epilogue."""
    V = m["num_disparities"] * h * w
    P = 1 if m["cost"] != "census" else -(-(m["census_window"] ** 2 - 1) // 32)
    record.append(roofline.launch("sgm_volume_kernel", 8 * P * h * w + 4 * V,
                                  V * roofline.cost_ops(m["cost"], m["window"], P)))
    for i in range(sg["directions"]):  # the first has no running sum to read
        record.append(roofline.launch("sgm_scan_kernel", (8 if i == 0 else 12) * V, 8 * V))
    record += [roofline.launch("sgm_wta_kernel", 4 * V + 16 * h * w, 3 * V),
               roofline.launch("lr_check_kernel", 9 * h * w, 12 * h * w),
               roofline.launch("fill_invalid_kernel", 9 * h * w, 4 * h * w),
               roofline.launch("median3_kernel", 8 * h * w, 38 * h * w)]


def check_config(cfg: dict) -> None:
    """Raise on what this reference does not follow."""
    m, sg = cfg["match"], cfg["sgm"]
    if cfg["backend"] != "sgm-pallas" or sg["volume_dtype"] != "f32":
        raise ValueError("sgm_wide reference: needs backend sgm-pallas with an f32 volume")
    if m["uniqueness"] is not None or not m["subpixel"] or m["lr_threshold"] is None:
        raise ValueError("sgm_wide reference: needs subpixel, an LR threshold, no uniqueness")
    if sg["directions"] != 8 or not 128 < m["num_disparities"] <= _MAX_D:
        raise ValueError("sgm_wide reference: follows the stored-sum path "
                         f"(8 directions, 128 < D ≤ {_MAX_D})")


def run_call(lefts, rights, cfg: dict, entry: dict, precision: str = "f32",
             record: Optional[List[list]] = None):
    """The outputs of one served call on f32 RGB frames [T, H, W, 3]: a
    ``(disparity, valid)`` per frame, each frame on its own."""
    check_config(cfg)
    if precision != "f32":
        raise ValueError("sgm_wide reference: the control is the program's own bf16 volume")
    outs = []
    for t in range(lefts.shape[0]):
        outs.append(sgm.match_frame(lefts[t], rights[t], cfg))
        if record is not None:
            rec = []
            _record(rec, cfg["match"], cfg["sgm"], *lefts.shape[1:3])
            record.append(rec)
    return outs

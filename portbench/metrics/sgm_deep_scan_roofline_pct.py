"""The deep scans' share of their roofline: the least time of every launch
the reference marks as run inside the program's ``stepth/sgm/deep`` spans
(``roofline.bound_s`` of its bytes, vol and acc read once and the sum
written once, and its operations), over the device time of the kernels
launched inside those spans in the trace (``sgm_deep_scan_ms_per_frame``).
None where the program opens no such span or the reference marks no
launch."""

from portbench import roofline
from portbench.metrics.sgm_deep_scan_ms_per_frame import SPAN, read as deep_ms


def read(run):
    ms = deep_ms(run)
    least = sum(roofline.bound_s(launch["bytes"], launch["ops"]) for launch in run.launches
                if launch.get("span") == SPAN)
    if not ms or least <= 0:
        return None
    return 100.0 * least / (ms * 1e-3 * run.traced_frames)

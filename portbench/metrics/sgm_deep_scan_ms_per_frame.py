"""Device ms a frame of the SGM's scans past 256 disparities: every kernel
launched inside one of the program's ``stepth/sgm/deep`` spans (K7 on its
deep tiling, nested in ``stepth/sgm/scan``), by correlation id on the
span's thread, over the traced frames. None where the program opens no
such span."""

from portbench.metrics.sgm_wta_ms_per_frame import device_ms_inside

SPAN = "stepth/sgm/deep"


def read(run):
    return device_ms_inside(run, SPAN)

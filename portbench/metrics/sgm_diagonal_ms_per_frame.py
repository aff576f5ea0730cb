"""Device ms a frame of the SGM's diagonal scans: every kernel launched
inside one of the program's ``stepth/sgm/diagonal`` spans (K7 with a
lateral step, nested in ``stepth/sgm/scan``), by correlation id on the
span's thread, over the traced frames. None where the program opens no
such span."""

from portbench.metrics.sgm_wta_ms_per_frame import device_ms_inside


def read(run):
    return device_ms_inside(run, "stepth/sgm/diagonal")

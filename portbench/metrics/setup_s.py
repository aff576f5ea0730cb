"""Seconds from the process's start to the first timed call: imports, the
CUDA context, the kernel library (built on a checkout's first run), the
frame pool and the warm-up calls."""


def read(run):
    return run.setup_s

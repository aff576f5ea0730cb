"""Device ms per frame of every traced kernel that is not one of the
port's own CUDA kernels: torch's census planes, grayscale, pools, plans,
buffer fills and conversions."""


def read(run):
    if run.trace is None or not run.traced_frames:
        return None
    glue = run.trace.kernel_seconds()[1]
    return 1e3 * glue / run.traced_frames

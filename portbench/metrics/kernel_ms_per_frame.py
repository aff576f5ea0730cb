"""Device ms per frame of the port's own CUDA kernels in the trace."""


def read(run):
    if run.trace is None or not run.traced_frames:
        return None
    port = run.trace.kernel_seconds()[0]
    if not port:
        return None
    return 1e3 * sum(sum(t) for t in port.values()) / run.traced_frames

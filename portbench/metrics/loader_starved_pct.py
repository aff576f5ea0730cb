"""Share of the loader's takes that found their item not yet made and
waited: 100 × ``loader.starved`` / ``loader.takes`` of the program's
counters (``stepth_tpu_torch.utils.tracing.counters()``), read after the
run, so over the warm-up, the window and any traced calls. The first take
of a stream always waits."""


def read(run):
    try:
        from stepth_tpu_torch.utils.tracing import counters
    except ImportError:  # a program without counters
        return None
    counted = counters()
    takes = counted.get("loader.takes", 0)
    if not takes:
        return None
    return 100.0 * counted.get("loader.starved", 0) / takes

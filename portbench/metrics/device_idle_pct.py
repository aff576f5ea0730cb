"""100 × (1 − busy share) of the card over the traced stretch: busy where a
kernel, copy or fill ran (their union)."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)

"""The 95th percentile (nearest rank) of every call of the window, from
taking the chunk's first pair off the loader to its last result in host
memory (host clock)."""

from portbench import stats


def read(run):
    if not run.calls:
        return None
    return 1e3 * stats.percentile([c["call"] for c in run.calls], 95)

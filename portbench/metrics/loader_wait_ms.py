"""Mean host ms a call spent taking its chunk's pairs off the loader (the
benchmark's span around ``next()`` on ``core.loader.PrefetchLoader``)."""


def read(run):
    return run.mean_ms("loader_wait")

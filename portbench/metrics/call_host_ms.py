"""Mean host ms from entering the model call until it returns, before the
benchmark waits for the card (synchronisation inside the call counts)."""


def read(run):
    return run.mean_ms("model_call")

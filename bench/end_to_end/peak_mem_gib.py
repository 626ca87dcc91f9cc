"""Device memory allocated at the window's peak (reset after the warm
batches): the index, the traffic pool and the batch's intermediates."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None

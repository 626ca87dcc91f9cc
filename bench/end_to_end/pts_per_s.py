"""Points mapped per second: every point of every batch completed in the
window, over the window's seconds (first dispatch to last ids ready)."""


def read(run):
    return run.batches * run.batch / run.window_s

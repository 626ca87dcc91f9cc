"""The host's time inside ``engine.assign`` a batch, in ms (mean over the
window's batches): issuing the batch's work, and any wait for the device
inside the program.  The benchmark's own span, no sync of its own."""


def read(run):
    return sum(run.issue_s) / len(run.issue_s) * 1e3 if run.issue_s else None

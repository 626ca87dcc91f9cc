"""The share of device time, in %, that kernels other than the program's
hand-written ones took (gathers, sorts, top-k, copies, fills) over the
traced stretch."""


def read(run):
    tr = run.trace
    total = tr.device_us() if tr is not None else 0.0
    if total <= 0:
        return None
    return 100.0 * tr.device_us(hand=False) / total

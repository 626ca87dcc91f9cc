"""The hand-written kernels' share of their roofline, in %: the sum over
the traced launches of the least time their inputs need on an H100
(``bench/work.py``: max(bytes / 3.35 TB/s, operations / 67 TFLOP/s)) over
the sum of the hand kernels' measured device time."""
from bench import work


def read(run):
    tr = run.trace
    measured = tr.device_us(hand=True) / 1e6 if tr is not None else 0.0
    if measured <= 0 or not run.launches:
        return None
    least = sum(work.least_seconds(b, o) for _, b, o in run.launches)
    return 100.0 * least / measured

"""The share of the traced stretch, in %, in which no kernel, copy or fill
ran on the device (1 - the union of their intervals / the stretch)."""


def read(run):
    tr = run.trace
    if tr is None or tr.window_us <= 0 or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_us() / tr.window_us)

"""95th percentile over all batches of the window of a batch's time from
dispatch to its ids being ready, in ms (nearest rank)."""
import math


def read(run):
    lat = sorted(run.latencies_s)
    return lat[math.ceil(0.95 * len(lat)) - 1] * 1e3

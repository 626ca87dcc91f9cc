"""Log-bucketed latency histograms for per-stage attribution (copy of
src/repro/obs/hist.py; DESIGN.md §15).

``LatencyWindow`` (serving/metrics.py) keeps the last N raw samples —
exact percentiles, but window-local and per-sample memory.  Stage
attribution needs the opposite trade: every observation ever, O(1)
memory, mergeable across servers/replicas, and percentiles good enough
to ratchet on.  ``LatencyHistogram`` is that structure:

* **fixed log-spaced buckets**: bucket ``i`` covers
  ``(lo * g**i, lo * g**(i+1)]`` with growth ``g = 2 ** (1/per_octave)``
  — the default (1 µs .. 64 s, 4 buckets per octave) resolves any
  quantile to within ±9% of its true value, constant across nine
  decades of latency;
* **mergeable**: two histograms with the same layout merge by summing
  counts — associative and commutative, so replica- or region-local
  histograms aggregate in any order (tested);
* **bounded error**: ``quantile`` answers with the geometric midpoint
  of the owning bucket — exact p50/p99 *within bucket resolution*, the
  contract the bench breakdown columns ratchet on.

Thread safety: one lock per histogram guards observe/merge/snapshot
(the counts array is a read-modify-write).  ``observe`` is a couple of
float ops + one array increment — cheap enough to run unsampled on the
serve path.
"""
from __future__ import annotations

import math
import threading

import numpy as np

__all__ = ["LatencyHistogram", "DEFAULT_LO_S", "DEFAULT_HI_S",
           "DEFAULT_PER_OCTAVE"]

DEFAULT_LO_S = 1e-6          # first bucket upper bound: 1 µs
DEFAULT_HI_S = 64.0          # last finite bound covers >= 64 s
DEFAULT_PER_OCTAVE = 4       # buckets per factor-of-2 (±9% resolution)


class LatencyHistogram:
    """Fixed-layout log-bucketed histogram (see module docstring)."""

    def __init__(self, lo: float = DEFAULT_LO_S, hi: float = DEFAULT_HI_S,
                 per_octave: int = DEFAULT_PER_OCTAVE):
        if lo <= 0 or hi <= lo or per_octave < 1:
            raise ValueError(f"bad layout lo={lo} hi={hi} "
                             f"per_octave={per_octave}")
        self.lo = float(lo)
        self.hi = float(hi)
        self.per_octave = int(per_octave)
        n = int(math.ceil(math.log2(hi / lo) * per_octave))
        # uppers[i] = inclusive upper bound of bucket i; bucket 0 also
        # absorbs everything <= lo (incl. 0), the last bucket is the
        # overflow (> uppers[-2], i.e. > hi).
        self.uppers = self.lo * np.exp2((np.arange(n) + 1.0)
                                        / self.per_octave)
        self.counts = np.zeros(n + 1, np.int64)
        self.count = 0
        self.sum = 0.0
        self.max = 0.0
        self._lock = threading.Lock()

    def layout(self) -> tuple:
        return (self.lo, self.hi, self.per_octave)

    def observe(self, seconds: float) -> None:
        s = float(seconds)
        ix = int(np.searchsorted(self.uppers, s, side="left"))
        with self._lock:
            self.counts[ix] += 1
            self.count += 1
            self.sum += s
            if s > self.max:
                self.max = s

    # -- aggregation ---------------------------------------------------------

    def merge(self, other: "LatencyHistogram") -> "LatencyHistogram":
        """New histogram = self + other.  Same-layout only (counts are
        meaningless across bucket layouts); associative + commutative,
        so region/replica histograms fold in any order."""
        if self.layout() != other.layout():
            raise ValueError(f"cannot merge layouts {self.layout()} "
                             f"and {other.layout()}")
        out = LatencyHistogram(self.lo, self.hi, self.per_octave)
        with self._lock:
            a_counts, a_count = self.counts.copy(), self.count
            a_sum, a_max = self.sum, self.max
        with other._lock:
            out.counts = a_counts + other.counts
            out.count = a_count + other.count
            out.sum = a_sum + other.sum
            out.max = max(a_max, other.max)
        return out

    # -- reading -------------------------------------------------------------

    def quantile(self, q: float) -> float:
        """Seconds at quantile ``q`` in [0, 1]: the geometric midpoint
        of the bucket holding the q-th observation (upper bound for the
        unbounded overflow bucket) — exact within one bucket's ±half
        resolution.  0.0 when empty."""
        with self._lock:
            counts, total = self.counts.copy(), self.count
        if total == 0:
            return 0.0
        rank = min(max(q, 0.0), 1.0) * total
        cum = np.cumsum(counts)
        ix = int(np.searchsorted(cum, max(rank, 1), side="left"))
        if ix >= len(self.uppers):          # overflow bucket
            return float(self.uppers[-1])
        # geometric midpoint of (upper/g, upper]; bucket 0's lower edge
        # is 0, so its midpoint uses the same formula against lo.
        return float(self.uppers[ix] * 2 ** (-0.5 / self.per_octave))

    def cumulative(self) -> list:
        """Prometheus-shaped cumulative buckets:
        [(upper_bound_seconds, cumulative_count), ...], truncated after
        the first bucket that already holds every observation (the
        all-equal tail carries no information; ``+Inf`` is the
        exposition layer's job)."""
        with self._lock:
            counts, total = self.counts.copy(), self.count
        cum = np.cumsum(counts[:len(self.uppers)])
        out = []
        for upper, c in zip(self.uppers, cum):
            out.append((float(upper), int(c)))
            if c == total:
                break
        return out

    def snapshot_ms(self) -> dict:
        """JSON-ready summary in milliseconds (p50/p90/p99 at bucket
        resolution, exact count/mean/max)."""
        with self._lock:
            total, ssum, smax = self.count, self.sum, self.max
        if total == 0:
            return {"count": 0, "p50": None, "p90": None, "p99": None,
                    "mean": None, "max": None}
        return {"count": int(total),
                "p50": self.quantile(0.50) * 1e3,
                "p90": self.quantile(0.90) * 1e3,
                "p99": self.quantile(0.99) * 1e3,
                "mean": ssum / total * 1e3,
                "max": smax * 1e3}

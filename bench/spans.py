"""The program's ``geo.*`` phase spans in a trace of the traced stretch.

``Trace`` (``bench/trace.py``) keeps the device operations, the
benchmark's own ranges and the host operators.  ``SpanTrace`` also keeps
what puts device time down to the program's phases:

* the program's ``geo.*`` ranges (``user_annotation`` events of the
  stretch's thread; ``repro_torch.obs.profile.span`` records them while a
  profiler captures);
* each runtime call of that thread (``cuda_runtime`` / ``cuda_driver``:
  kernel launches, copies, synchronisations) with its ``correlation``;
* each device operation's ``correlation``, the id its launch carries.

A device operation belongs to a span when its launch lies inside it.  An
operation with no launch event belongs to no span.  The readings a batch
(``ms_per_batch``, ``host_syncs_per_batch``) divide by the number of
``geo.assign`` spans in the stretch, one a call of ``GeoEngine.assign``.
"""
from __future__ import annotations

import bisect

from bench.trace import DEVICE_CATS, Trace

ASSIGN = "geo.assign"
# The spans that hold every device operation ``geo.assign`` launches.
LEAVES = ("geo.fast.locate", "geo.fast.onepass", "geo.fast.parents",
          "geo.simple.bbox", "geo.simple.stats", "geo.hybrid.handoff",
          "geo.resolve.compact", "geo.resolve.candidates",
          "geo.resolve.pip", "geo.resolve.scatter")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
# Runtime calls that make the host wait for the device.
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")


def _merged(intervals) -> list:
    """Sorted, disjoint [start, end) intervals covering ``intervals``."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _inside(t: float, merged: list) -> bool:
    i = bisect.bisect_right(merged, [t, float("inf")]) - 1
    return i >= 0 and merged[i][0] <= t < merged[i][1]


class SpanTrace(Trace):
    def __init__(self, events: list, hand_names: set):
        super().__init__(events, hand_names)
        self.spans = []       # (name, start, end): the program's geo.* spans
        self.runtime = []     # (name, start, correlation): runtime calls
        self.device_corr = []  # (correlation, start, end): device operations
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            ts, te = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            cat = str(e.get("cat", "")).lower()
            corr = (e.get("args") or {}).get("correlation")
            if cat in DEVICE_CATS:
                if te > self.t0 and ts < self.t1:
                    self.device_corr.append((corr, ts, te))
            elif (e.get("pid"), e.get("tid")) != self.tid:
                continue
            elif cat in RUNTIME_CATS:
                self.runtime.append((e.get("name"), ts, corr))
            elif (cat == "user_annotation"
                  and str(e.get("name", "")).startswith("geo.")
                  and te > self.t0 and ts < self.t1):
                self.spans.append((e["name"], ts, te))
        self._launch_ts = {c: ts for _, ts, c in self.runtime
                           if c is not None}

    def _within(self, names) -> list:
        return _merged((ts, te) for n, ts, te in self.spans if n in names)

    def span_device_us(self, *names) -> float:
        """Device time (clipped to the stretch) of the operations whose
        launch lies inside a span of one of ``names``; an operation under
        nested spans of those names counts once."""
        merged = self._within(names)
        return sum(min(te, self.t1) - max(ts, self.t0)
                   for corr, ts, te in self.device_corr
                   if corr in self._launch_ts
                   and _inside(self._launch_ts[corr], merged))

    def span_calls(self, names) -> int:
        """Runtime calls named in ``names`` made inside ``geo.assign``."""
        merged = self._within((ASSIGN,))
        return sum(1 for n, ts, _ in self.runtime
                   if n in names and _inside(ts, merged))

    def batches(self) -> int:
        """``geo.assign`` spans that start inside the stretch."""
        return sum(1 for n, ts, _ in self.spans
                   if n == ASSIGN and self.t0 <= ts < self.t1)

    def _host_at(self, t: float) -> str:
        """Trace's name of the host at ``t``, with the innermost program
        span inserted after the benchmark's range."""
        base = super()._host_at(t)
        inner = [(te - ts, name) for name, ts, te in self.spans
                 if ts <= t < te]
        if not inner:
            return base
        rng, _, op = base.partition("/")
        return "/".join(p for p in (rng, min(inner)[1], op) if p)


def _batches(tr) -> int:
    """``geo.assign`` spans of a ``SpanTrace`` that holds device
    operations; 0 for any other trace (a plain ``Trace`` included)."""
    if not isinstance(tr, SpanTrace) or not tr.device:
        return 0
    return tr.batches()


def ms_per_batch(tr, *names):
    """Device ms a traced batch under spans of ``names``; None where the
    trace holds no device operation or no ``geo.assign``."""
    n = _batches(tr)
    return tr.span_device_us(*names) / 1e3 / n if n else None


def host_syncs_per_batch(tr):
    """``SYNC_CALLS`` made inside ``geo.assign``, a traced batch; None
    where the trace holds no device operation or no ``geo.assign``."""
    n = _batches(tr)
    return tr.span_calls(SYNC_CALLS) / n if n else None


def unspanned_share(tr):
    """Share, in %, of ``geo.assign``'s device time launched under no
    leaf span; None where ``geo.assign`` launched nothing."""
    total = tr.span_device_us(ASSIGN) if _batches(tr) else 0.0
    if total <= 0:
        return None
    return 100.0 * (1.0 - tr.span_device_us(*LEAVES) / total)

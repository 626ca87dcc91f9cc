"""Counters / histograms registry for GeoServer (copy of
src/repro/serving/metrics.py; DESIGN.md §10, §15).

One registry per server accumulates everything the ROADMAP's serving item
asks to surface: the per-request ``GeoStats``/``ResolveStats`` counters
(``phase2_miss`` front and centre — a non-zero value says the two-phase
PIP's cap2 is undersized for live traffic — plus overflow and boundary
fraction), cache hit/miss traffic, queue depth, batch-fill ratio (valid
rows / padded slots — how much of the bucket ladder's padding is waste),
deadline-triggered flushes (``deadline_flushes`` — how often the
``max_delay_ms`` SLO clock, not the size trigger, forced a batch out),
request latency percentiles over a sliding sample window, per-region
index memory footprints (edge-pool bytes / block sizes — gauges set at
server construction from ``GeoIndexSet.memory_footprint``), and —
DESIGN.md §15 — **per-stage latency histograms** (``queue_wait`` /
``host_prepare`` / ``device_assign`` / ``merge`` / ``request``:
log-bucketed, mergeable, always on) so an SLO breach attributes to a
stage, not just to "the server".

``snapshot()`` renders the whole registry as one JSON-ready dict:

    {"counters": {...},                 # monotonic sums
     "gauges": {...},                   # last-set values (queue depth,
                                        # cache absolutes)
     "derived": {"cache_hit_rate", "batch_fill_ratio",
                 "boundary_fraction", ...},
     "stages": {"queue_wait": {"count", "p50", "p90", "p99", "mean",
                               "max"}, ...},
     "latency_ms": {"count_total", "count_window", "p50", ...}}

Scrapers diff counters between snapshots — which is exactly why cache
absolutes live in ``gauges``: the cache owns its totals and a clear or
restart would rewind a counter, producing phantom negative deltas.  The
monotonic serving-side twins (``cache_hits_total`` & co.) are
incremented at the observation sites in ``server.py`` and never rewind.
The derived block is recomputed from the registry at snapshot time so
it is always self-consistent.

``expose_text()`` renders the same registry as Prometheus-style text
exposition (counters with a ``_total`` suffix, gauges, and per-stage
``stage_latency_seconds`` histograms with cumulative ``le`` buckets) —
``GeoServer.metrics_text()`` refreshes and returns it, ready to serve
from a ``/metrics`` endpoint.

**Thread safety** (DESIGN.md §14): the registry is written from submitter
threads, the flusher, and every replica worker at once, so ``inc`` (a
read-modify-write that would silently lose updates), gauge sets, and the
latency window all run under one registry lock; ``snapshot`` takes the
same lock so a scrape never sees a half-applied GeoStats fold.  The
latency window and each stage histogram have their own locks because
they are exported standalone.
"""
from __future__ import annotations

import json
import re
import threading
from collections import deque

import numpy as np

from repro_torch.obs.hist import LatencyHistogram

# The serve-path stages every server observes (servers may add more —
# the dict is open); kept in pipeline order for rendering.
STAGES = ("queue_wait", "host_prepare", "device_assign", "merge",
          "request")

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _metric_name(name: str) -> str:
    """Prometheus-legal metric name (best effort)."""
    name = _NAME_RE.sub("_", str(name))
    if not name or not (name[0].isalpha() or name[0] in "_:"):
        name = "_" + name
    return name


def _fmt_num(value) -> str:
    """Exposition number formatting: integers bare, floats via %g."""
    f = float(value)
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return format(f, "g")


class LatencyWindow:
    """Sliding window of the most recent N latency samples; percentiles
    are exact over the window.  This is deliberately NOT a streaming
    sketch — the repo's one streaming-quantile implementation is
    ``repro_torch.obs.hist.LatencyHistogram`` (log-bucketed, mergeable), which
    ``ServerMetrics.observe_latency`` feeds in parallel with this
    window; the streaming *distinct-count* story is
    ``repro_torch.analytics.sketch.DistinctSketch``.  Keep this class a plain
    exact window: it answers "recent-p99" with zero bucketing error,
    and the histogram answers everything long-horizon.  Observe/snapshot
    are lock-guarded: percentiles are taken over a stable copy, never a
    deque mid-append.

    ``snapshot_ms`` reports **both** counts: ``count_total`` (lifetime
    observations) and ``count_window`` (samples the percentiles are
    actually computed over) — a dashboard must never read a
    4096-sample p99 as covering millions of requests."""

    def __init__(self, window: int = 4096):
        self._samples: deque = deque(maxlen=int(window))  # guarded-by: _lock
        self._lock = threading.Lock()
        self.count = 0                 # guarded-by: _lock

    def observe(self, seconds: float) -> None:
        with self._lock:
            self._samples.append(float(seconds))
            self.count += 1

    def snapshot_ms(self) -> dict:
        with self._lock:
            if not self._samples:
                return {"count_total": self.count, "count_window": 0,
                        "p50": None, "p90": None, "p99": None,
                        "max": None}
            s = np.asarray(self._samples) * 1e3
            count = self.count
        return {"count_total": count, "count_window": len(s),
                "p50": float(np.percentile(s, 50)),
                "p90": float(np.percentile(s, 90)),
                "p99": float(np.percentile(s, 99)),
                "max": float(s.max())}


class ServerMetrics:
    """The registry (see module docstring)."""

    def __init__(self, latency_window: int = 4096):
        self.counters: dict[str, float] = {}  # guarded-by: _lock
        self.gauges: dict[str, float] = {}    # guarded-by: _lock
        self.latency = LatencyWindow(latency_window)
        # Per-stage histograms, created lazily so custom stages are
        # first-class; the well-known serve stages are in STAGES.
        self._stages: dict[str, LatencyHistogram] = {}  # guarded-by: _lock
        # RLock: observe_geo/observe_cache/observe_footprint compose the
        # primitive inc/set under one holder.
        self._lock = threading.RLock()

    def inc(self, name: str, value=1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + value

    def set_gauge(self, name: str, value) -> None:
        with self._lock:
            self.gauges[name] = value

    def stage(self, name: str) -> LatencyHistogram:
        """The named stage's histogram (created on first use)."""
        with self._lock:
            hist = self._stages.get(name)
            if hist is None:
                hist = self._stages[name] = LatencyHistogram()
            return hist

    def observe_stage(self, name: str, seconds: float) -> None:
        self.stage(name).observe(seconds)

    def observe_latency(self, seconds: float) -> None:
        """End-to-end request latency: feeds both the exact sliding
        window and the mergeable ``request`` stage histogram."""
        self.latency.observe(seconds)
        self.observe_stage("request", seconds)

    def observe_geo(self, stats) -> None:
        """Fold one micro-batch's GeoStats into ``geo_*`` counters
        (``as_dict`` flattens phase2_miss / overflow / boundary count
        uniformly across strategies).  One lock hold for the whole fold:
        a concurrent snapshot sees all of a batch's counters or none."""
        with self._lock:
            for key, value in stats.as_dict().items():
                self.inc(f"geo_{key}", value)

    def observe_footprint(self, prefix: str, footprint: dict) -> None:
        """Record an index artifact's device-memory footprint
        (``GeoIndexSet.memory_footprint``: edge-pool bytes/blocks and
        the chosen pool block size) as ``<prefix>``-namespaced gauges.
        Set, not summed — the footprint is a property of the built
        index, refreshed whenever the server re-observes it."""
        with self._lock:
            for key, value in footprint.items():
                self.set_gauge(f"{prefix}{key}", value)

    def observe_cache(self, snap: dict) -> None:
        """Absorb a HotCellCache snapshot.  Cache counters are absolute
        (the cache owns them, and a cache clear/restart rewinds them),
        so they are **gauges** — set, never summed: a scraper diffing
        ``counters`` must not see phantom negative deltas.  The
        monotonic ``cache_*_total`` twins are incremented at the
        observation sites in ``server.py`` and count per-*point*
        traffic (the cache's own numbers count deduplicated per-batch
        probes, so traffic >= probes)."""
        with self._lock:
            for key in ("hits", "misses", "insertions", "evictions",
                        "entries"):
                self.gauges[f"cache_{key}"] = snap[key]

    # -- rendering ---------------------------------------------------------

    def _derived(self) -> dict:
        c = self.counters.get
        g = self.gauges.get
        d = {}
        # Hit rate from the cache's own absolutes (gauges): exactly the
        # cache's lifetime ratio, immune to scrape timing.
        probes = g("cache_hits", 0) + g("cache_misses", 0)
        d["cache_hit_rate"] = g("cache_hits", 0) / probes if probes else 0.0
        slots = c("padded_slots", 0)
        d["batch_fill_ratio"] = c("valid_slots", 0) / slots if slots else 0.0
        served = c("points_served", 0)
        d["boundary_fraction"] = \
            c("geo_n_boundary", 0) / served if served else 0.0
        d["pip_per_point"] = c("geo_n_pip", 0) / served if served else 0.0
        return d

    def snapshot(self) -> dict:
        with self._lock:
            snap = {"counters": dict(self.counters),
                    "gauges": dict(self.gauges),
                    "derived": self._derived()}
            stages = dict(self._stages)
        snap["stages"] = {name: hist.snapshot_ms()
                          for name, hist in stages.items()}
        snap["latency_ms"] = self.latency.snapshot_ms()
        return snap

    def to_json(self, indent=None) -> str:
        return json.dumps(self.snapshot(), indent=indent, sort_keys=True)

    def expose_text(self) -> str:
        """Prometheus-style text exposition of the whole registry:

            requests_total 42
            queue_depth_points 0
            stage_latency_seconds_bucket{stage="queue_wait",le="..."} 7

        Counters get a ``_total`` suffix (monotonic by construction);
        gauges render bare; every stage histogram renders cumulative
        ``le`` buckets (truncated after the bucket holding every
        sample — the all-equal tail), ``+Inf``, ``_sum`` and
        ``_count``.  Deterministic ordering (sorted names) so the
        output is golden-testable and diff-friendly."""
        with self._lock:
            counters = dict(self.counters)
            gauges = dict(self.gauges)
            stages = dict(self._stages)
        lines = []
        for name in sorted(counters):
            mname = _metric_name(name)
            if not mname.endswith("_total"):
                mname += "_total"
            lines.append(f"# TYPE {mname} counter")
            lines.append(f"{mname} {_fmt_num(counters[name])}")
        for name in sorted(gauges):
            mname = _metric_name(name)
            lines.append(f"# TYPE {mname} gauge")
            lines.append(f"{mname} {_fmt_num(gauges[name])}")
        if stages:
            lines.append("# TYPE stage_latency_seconds histogram")
            for name in sorted(stages):
                hist = stages[name]
                label = f'stage="{_metric_name(name)}"'
                for upper, cum in hist.cumulative():
                    lines.append(
                        f'stage_latency_seconds_bucket{{{label},'
                        f'le="{format(upper, "g")}"}} {cum}')
                with hist._lock:
                    count, total = hist.count, hist.sum
                lines.append(f'stage_latency_seconds_bucket{{{label},'
                             f'le="+Inf"}} {count}')
                lines.append(f'stage_latency_seconds_sum{{{label}}} '
                             f'{format(total, "g")}')
                lines.append(f'stage_latency_seconds_count{{{label}}} '
                             f'{count}')
        return "\n".join(lines) + "\n"

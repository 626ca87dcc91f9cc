"""Request tracing for the geo serving stack (copy of
src/repro/obs/trace.py; DESIGN.md §15).

The serving benchmarks can say *that* a latency SLO broke; this module
says *where* the milliseconds went.  A ``Tracer`` hands out one
``RequestTrace`` per sampled request; the serving layer records spans
against it as the request moves through the pipeline::

    request                      (root: submit -> future resolved)
      ├─ submit                  (client call -> accepted by the queue)
      ├─ queue_wait              (in the batcher, re-opened per retry)
      ├─ host_prepare            (HOST stage, per micro-batch)
      │    ├─ route              (region ownership masks)
      │    ├─ cache_lookup       (hot-cell probe, per region)
      │    └─ cache_learn        (interior-code inserts, per region)
      ├─ device_assign           (padded engine assign, per region)
      ├─ retry                   (instant: batch failed, slices requeued)
      └─ merge                   (ticket fills -> request completion)

Spans carry explicit parentage (``parent_id``), a monotonic
``time.perf_counter`` interval, the recording thread, and free-form
attributes (region, bucket, attempt, ...), so one request's timeline
reconstructs even when its micro-batches complete on different replica
threads or survive requeues and retries.

**Sampling** is head-based and atomic per request: the keep/drop
decision is made once, at ``start_trace``, with a deterministic
credit accumulator (exact long-run rate, no RNG); an unsampled request
gets ``None`` and *no* code path records a child span for it — whole
requests drop, orphan children are impossible by construction.  The
default ~1% rate keeps tracing on in production without drowning the
hot path (the overhead budget is enforced by
``benchmarks/trace_overhead.py``).

**Storage** is a bounded, lock-guarded ``SpanBuffer`` (drop-oldest,
drops counted) so a long-running server cannot leak memory through its
own observability.

**Export**: ``export_spans`` writes the raw span dump (JSON list);
``export_chrome`` writes the Chrome-trace / Perfetto event format
(``chrome://tracing`` opens it directly) with one *process* row per
request and one *thread* row per serving thread, which is exactly the
per-request timeline view.
"""
from __future__ import annotations

import dataclasses
import json
import threading
import time
from collections import deque
from typing import Optional

__all__ = ["Span", "SpanBuffer", "RequestTrace", "Tracer"]


@dataclasses.dataclass(frozen=True)
class Span:
    """One finished interval.  ``t0``/``t1`` are ``time.perf_counter``
    seconds (monotonic, comparable only within a process)."""

    trace_id: int
    span_id: int
    parent_id: Optional[int]
    name: str
    t0: float
    t1: float
    thread: str
    attrs: dict

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["dur_ms"] = (self.t1 - self.t0) * 1e3
        return d


class SpanBuffer:
    """Bounded drop-oldest span store.  Appends and snapshots run under
    one lock; overflow is counted (``dropped``), never raised — tracing
    must not be able to fail the serve path."""

    def __init__(self, capacity: int = 1 << 16):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = int(capacity)
        self._spans: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self.dropped = 0

    def append(self, span: Span) -> None:
        with self._lock:
            if len(self._spans) == self.capacity:
                self.dropped += 1
            self._spans.append(span)

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)

    def snapshot(self) -> list:
        """Stable copy of the buffered spans (oldest first)."""
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self.dropped = 0


class RequestTrace:
    """One sampled request's span handle.  The root span's interval is
    [the ``t0`` given to ``start_trace``, the ``end()`` call]; children
    are recorded eagerly as their stages finish.  Thread-safe: span-id
    allocation and buffer appends go through the owning tracer's lock
    and lock-guarded buffer."""

    __slots__ = ("tracer", "trace_id", "root_id", "_t0", "_ended")

    def __init__(self, tracer: "Tracer", trace_id: int, root_id: int,
                 t0: float):
        self.tracer = tracer
        self.trace_id = trace_id
        self.root_id = root_id
        self._t0 = t0
        self._ended = False

    def span(self, name: str, t0: float, t1: float,
             parent: Optional[int] = None, **attrs) -> int:
        """Record one finished child span; returns its span id (usable
        as ``parent`` for sub-spans).  ``parent=None`` parents to the
        root span."""
        sid = self.tracer._next_span_id()
        self.tracer.buffer.append(Span(
            trace_id=self.trace_id, span_id=sid,
            parent_id=self.root_id if parent is None else parent,
            name=name, t0=float(t0), t1=float(t1),
            thread=threading.current_thread().name, attrs=dict(attrs)))
        return sid

    def event(self, name: str, **attrs) -> int:
        """Instant (zero-duration) child span at now — retries et al."""
        now = time.perf_counter()
        return self.span(name, now, now, **attrs)

    def end(self, t1: Optional[float] = None, **attrs) -> None:
        """Close the root span (records it).  Idempotent: a request can
        fail after partial service and both paths may try to close it —
        the first close wins, so every sampled request has exactly one
        root span."""
        with self.tracer._lock:
            if self._ended:
                return
            self._ended = True
            sid = self.root_id
        self.tracer.buffer.append(Span(
            trace_id=self.trace_id, span_id=sid, parent_id=None,
            name="request", t0=self._t0,
            t1=time.perf_counter() if t1 is None else float(t1),
            thread=threading.current_thread().name, attrs=dict(attrs)))


class Tracer:
    """Per-server span factory: head-based sampling + bounded buffer +
    exporters (see module docstring)."""

    def __init__(self, sample_rate: float = 0.01,
                 capacity: int = 1 << 16):
        if not 0.0 <= sample_rate <= 1.0:
            raise ValueError(f"sample_rate must be in [0, 1], "
                             f"got {sample_rate}")
        self.sample_rate = float(sample_rate)
        self.buffer = SpanBuffer(capacity)
        self._lock = threading.Lock()
        self._credit = 0.0          # deterministic sampling accumulator
        self._ids = 0               # shared trace/span id counter
        self.started = 0            # requests seen
        self.sampled = 0            # requests kept

    def _next_span_id(self) -> int:
        with self._lock:
            self._ids += 1
            return self._ids

    def start_trace(self, t0: Optional[float] = None
                    ) -> Optional[RequestTrace]:
        """The head-based sampling gate: returns a ``RequestTrace`` for
        a kept request, ``None`` for a dropped one.  The decision is a
        credit accumulator (+rate per request, spend 1.0 to sample), so
        exactly ``round(n * rate)`` of every n requests are kept, in a
        deterministic pattern — reproducible traces, no RNG on the hot
        path."""
        with self._lock:
            self.started += 1
            self._credit += self.sample_rate
            if self._credit < 1.0:
                return None
            self._credit -= 1.0
            self.sampled += 1
            self._ids += 2
            trace_id, root_id = self._ids - 1, self._ids
        return RequestTrace(self, trace_id, root_id,
                            time.perf_counter() if t0 is None else t0)

    # -- export --------------------------------------------------------------

    def spans_json(self) -> list:
        return [s.as_dict() for s in self.buffer.snapshot()]

    def export_spans(self, path: str) -> int:
        """Raw span dump: a JSON list of span dicts; returns span
        count."""
        spans = self.spans_json()
        with open(path, "w") as f:
            json.dump({"spans": spans, "dropped": self.buffer.dropped,
                       "started": self.started, "sampled": self.sampled},
                      f, indent=1)
        return len(spans)

    def chrome_events(self) -> list:
        """Chrome-trace events: one complete ("X") event per span, with
        ``pid`` = the request (so every request gets its own process row
        in chrome://tracing / Perfetto — the per-request timeline view)
        and ``tid`` = the serving thread, named via metadata events.
        Timestamps re-base to the earliest span so they start near 0."""
        spans = self.buffer.snapshot()
        if not spans:
            return []
        epoch = min(s.t0 for s in spans)
        tids: dict[str, int] = {}
        events = []
        seen_threads = set()
        for s in spans:
            tid = tids.setdefault(s.thread, len(tids) + 1)
            if (s.trace_id, tid) not in seen_threads:
                seen_threads.add((s.trace_id, tid))
                events.append({"ph": "M", "name": "thread_name",
                               "pid": s.trace_id, "tid": tid,
                               "args": {"name": s.thread}})
            args = {"trace_id": s.trace_id, "span_id": s.span_id,
                    "parent_id": s.parent_id}
            args.update(s.attrs)
            events.append({"ph": "X", "cat": "serve", "name": s.name,
                           "pid": s.trace_id, "tid": tid,
                           "ts": (s.t0 - epoch) * 1e6,
                           "dur": max((s.t1 - s.t0) * 1e6, 0.0),
                           "args": args})
        return events

    def export_chrome(self, path: str) -> int:
        """Chrome-trace file (open in chrome://tracing or Perfetto);
        returns the event count."""
        events = self.chrome_events()
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"},
                      f, indent=1)
        return len(events)

    def stats(self) -> dict:
        with self._lock:
            started, sampled = self.started, self.sampled
        return {"started": started, "sampled": sampled,
                "buffered": len(self.buffer),
                "dropped": self.buffer.dropped,
                "sample_rate": self.sample_rate}

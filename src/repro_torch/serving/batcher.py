"""Micro-batching request queue for GeoServer (copy of
src/repro/serving/batcher.py; DESIGN.md §10).

Streaming serving sees requests of every shape: one point from a mobile
check-in, thousands from a bulk upload.  Device batches are padded up a
small geometric ladder of **bucket sizes** (default 256 / 1k / 4k /
16k), so the engine sees a handful of shapes: in the JAX package each
strategy compiles once per bucket; in the port the caching allocator
reuses the same few block sizes, and ``GeoServer.warm()`` pre-pays the
kernel build and first allocations before traffic arrives.  The batcher coalesces
queued requests FIFO into micro-batches capped at the top bucket; the
*padding* itself (``bucket_for`` + ``pad_points``, defined here) is
applied by the server at the device edge — after cache hits and region
routing have shrunk the batch — so padded-slot accounting reflects what
the engine actually computes.  Pad rows are neutralized downstream by
``GeoEngine.assign_padded`` (FAR rewrite — they cannot perturb results or
stats), so over-padding costs only lane-aligned compute, never accuracy.

Backpressure is a bounded queue (``max_queue_points``) with two policies:

  * ``block`` — an arriving request that would overflow the bound makes
    the caller flush first (serve-now semantics in the synchronous loop);
  * ``shed``  — the request is refused with ``QueueFull`` and counted, the
    load-shedding answer when latency matters more than completeness.

The batcher is deliberately dumb about *what* a request is: it queues
(ticket, points) pairs and hands back ``MicroBatch`` objects whose
``parts`` say which slice of which ticket each batch row belongs to — the
server owns result assembly, metrics, and caching.

**Thread safety** (DESIGN.md §14): every public method runs under one
internal condition variable, so N producer threads can race ``put``
against a flusher's ``drain``/``requeue`` without losing or duplicating
a ticket, and FIFO order survives a requeue under contention (the
requeue's extendleft is atomic).  ``put(wait=True)`` turns the "block"
policy's caller-must-flush handshake into a real block: the producer
sleeps on the condition until a drain frees room — the async front-end's
backpressure.  ``wait_for_work`` is the flusher side: sleep until the
queue goes non-empty.  The single-threaded serving loop pays one
uncontended lock acquire per call, which is noise next to a device batch.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Optional

import numpy as np

DEFAULT_BUCKETS = (256, 1024, 4096, 16384)


class QueueFull(RuntimeError):
    """Raised under the ``shed`` policy when the queue bound is hit."""


def bucket_for(n: int, buckets=DEFAULT_BUCKETS) -> int:
    """Smallest ladder bucket >= n (callers split anything larger than
    the top bucket, so it also answers for oversized n)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _stamp(ticket: Any) -> None:
    """Tell a ticket it just (re-)entered the queue — the per-request
    queue-wait clock (DESIGN.md §15).  Duck-typed so the batcher stays
    ticket-agnostic: anything without ``mark_enqueued`` (tests use bare
    strings) is silently skipped."""
    mark = getattr(ticket, "mark_enqueued", None)
    if mark is not None:
        mark()


def pad_points(points: np.ndarray, bucket: int) -> np.ndarray:
    """[n, 2] -> [bucket, 2] f32, zero-padded (the pad *value* is
    irrelevant — ``assign_padded`` rewrites pad rows to FAR)."""
    out = np.zeros((bucket, 2), np.float32)
    out[:len(points)] = points
    return out


@dataclasses.dataclass
class MicroBatch:
    """One coalesced batch (unpadded — the server pads each engine
    sub-batch up the ladder at the device edge, after cache hits and
    routing have shrunk it) plus the bookkeeping to scatter results
    back: ``parts`` rows are (ticket, req_off, batch_off, length)."""

    points: np.ndarray          # [n, 2] f32, n <= top bucket
    parts: list


class MicroBatcher:
    """Bounded FIFO request queue that drains into bucket-padded
    micro-batches (see module docstring)."""

    def __init__(self, buckets=DEFAULT_BUCKETS,
                 max_queue_points: int = 1 << 16, policy: str = "block"):
        buckets = tuple(int(b) for b in buckets)
        if not buckets or any(b <= 0 for b in buckets) \
                or list(buckets) != sorted(set(buckets)):
            raise ValueError(f"buckets must be ascending positive ints, "
                             f"got {buckets!r}")
        if policy not in ("block", "shed"):
            raise ValueError(f"unknown backpressure policy {policy!r}; "
                             f"expected 'block' or 'shed'")
        self.buckets = buckets
        self.max_queue_points = int(max_queue_points)
        self.policy = policy
        # (ticket, points [n, 2] f32, base_off): base_off is the slice's
        # offset inside its original request — 0 for fresh puts, > 0 for
        # requeued tails of split requests (see ``requeue``).
        self._q: deque = deque()       # guarded-by: _cond
        self.queued_points = 0         # guarded-by: _cond
        # perf_counter of the oldest queued arrival — the deadline-flush
        # clock (GeoServer's ``max_delay_ms``).  Armed when the queue
        # goes non-empty, cleared on drain; a requeue after a failed
        # flush RE-ARMS it (see ``requeue``), so the deadline bounds the
        # wait since the last serve attempt, not since first arrival.
        self._oldest_ts: Optional[float] = None  # guarded-by: _cond
        # One condition guards every mutation: producers wait on it for
        # room (``put(wait=True)``), the flusher waits on it for work
        # (``wait_for_work``); drain/requeue notify both sides.
        self._cond = threading.Condition()

    def __len__(self) -> int:
        with self._cond:
            return len(self._q)

    def oldest_age_s(self) -> float:
        """Seconds the oldest queued request has been waiting (0.0 when
        the queue is empty).  Monotone non-decreasing while the queue
        stays non-empty: later puts never reset the clock."""
        with self._cond:
            if self._oldest_ts is None:
                return 0.0
            return time.perf_counter() - self._oldest_ts

    def _has_room(self, n: int) -> bool:
        # An empty queue always accepts (a single request larger than
        # the bound must still be servable — it just flushes alone).
        return (not self._q
                or self.queued_points + n <= self.max_queue_points)

    def put(self, ticket: Any, points: np.ndarray, *, wait: bool = False,
            timeout: Optional[float] = None) -> bool:
        """Enqueue one request.  Returns False when the ``block`` policy
        wants the caller to flush first; raises QueueFull under ``shed``.

        ``wait=True`` (the threaded front-end's spelling of "block")
        sleeps on the internal condition until a drain frees room instead
        of returning False — returning False only if ``timeout`` elapses
        first.  ``shed`` raises immediately either way: load-shedding
        must not stall the producer."""
        points = np.asarray(points, np.float32)
        n = len(points)
        with self._cond:
            if not self._has_room(n):
                if self.policy == "shed":
                    raise QueueFull(
                        f"queue holds {self.queued_points} points, request "
                        f"of {n} exceeds "
                        f"max_queue_points={self.max_queue_points}")
                if not wait:
                    return False
                if not self._cond.wait_for(lambda: self._has_room(n),
                                           timeout):
                    return False
            self._q.append((ticket, points, 0))
            _stamp(ticket)                 # queue-wait clock starts here
            self.queued_points += n
            if self._oldest_ts is None:
                self._oldest_ts = time.perf_counter()
            self._cond.notify_all()        # wake a flusher waiting for work
            return True

    def wait_for_work(self, timeout: Optional[float] = None) -> bool:
        """Block until the queue is non-empty (True) or ``timeout``
        elapses (False) — the flusher loop's idle sleep."""
        with self._cond:
            return self._cond.wait_for(lambda: bool(self._q), timeout)

    def requeue(self, entries) -> None:
        """Push (ticket, points, base_off) slices back to the FRONT of
        the queue, preserving their order — the server's recovery path
        when a flush dies mid-serve, so drained-but-unserved work is
        never lost (it simply serves on the next flush).  Requeued work
        is by definition the oldest in the queue: the deadline clock
        restarts at the requeue (the original arrival time left with
        ``drain``), so a crash-looping flush still re-arms the deadline
        rather than firing it on every retry.  Atomic under the batcher
        lock, so concurrent puts can neither interleave into the requeued
        run nor observe it half-inserted — FIFO order survives
        contention."""
        with self._cond:
            if entries and self._oldest_ts is None:
                self._oldest_ts = time.perf_counter()
            self._q.extendleft(reversed(entries))
            for ticket, _, _ in entries:   # re-arm per-ticket wait clocks
                _stamp(ticket)
            self.queued_points += sum(len(p) for _, p, _ in entries)
            if entries:
                self._cond.notify_all()

    def drain(self) -> list:
        """Coalesce every queued request, FIFO, into micro-batches of at
        most the top bucket.  Requests pack together until the top bucket
        is full; a request longer than the remaining room is split across
        batches (its parts record the request-side offsets).  Atomic: a
        put racing a drain lands either wholly in this drain's batches or
        wholly in the queue for the next one — never split between."""
        top = self.buckets[-1]
        batches: list[MicroBatch] = []
        chunks: list[np.ndarray] = []
        parts: list = []
        fill = 0

        def close():
            nonlocal chunks, parts, fill
            if fill:
                batches.append(
                    MicroBatch(np.concatenate(chunks, axis=0), parts))
            chunks, parts, fill = [], [], 0

        with self._cond:
            while self._q:
                ticket, pts, base = self._q.popleft()
                off = 0
                while off < len(pts):
                    take = min(len(pts) - off, top - fill)
                    if take == 0:
                        close()
                        continue
                    chunks.append(pts[off:off + take])
                    parts.append((ticket, base + off, fill, take))
                    fill += take
                    off += take
            close()
            self.queued_points = 0
            self._oldest_ts = None
            self._cond.notify_all()        # room freed: wake blocked puts
        return batches

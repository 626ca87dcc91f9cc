"""AsyncGeoServer: the concurrent GeoServer front-end (port of
src/repro/serving/frontend.py; DESIGN.md §14).

``GeoServer`` is a synchronous facade — one thread, one request round
trip at a time.  The paper's serving claim (100M+ projections/sec for
pandemic-response queries) and its deployed analogues (mContain's
encounter-density service) are *concurrent* services: many clients in
flight, batches coalesced across them, multiple engine replicas draining
one queue.  This module is that layer, built on the same machinery:

    server = AsyncGeoServer.build(census, strategy="fast",   # on cuda
                                  frontend=FrontendConfig(n_replicas=4))
    fut = server.submit_async(points)     # concurrent-safe, returns now
    res = fut.result()                    # ServeResult, same contract
    server.close()                        # or: with AsyncGeoServer...

Three thread groups, each owning one stage of the serve path:

  * **submitters** (``FrontendConfig.n_submitters`` pool): turn
    ``submit_async`` into a queued ticket without blocking the caller.
    Backpressure lives here — under the "block" policy a submitter
    sleeps on the batcher's condition until a drain frees room; under
    "shed" the ticket's future fails with ``QueueFull`` immediately.
  * **one flusher**: the deadline/size loop.  Sleeps on
    ``MicroBatcher.wait_for_work``, drains when the queue reaches
    ``flush_points`` or the oldest request ages past the deadline
    (``ServeConfig.max_delay_ms``, falling back to
    ``FrontendConfig.max_delay_ms`` so trickle traffic is never
    stranded), then runs the HOST stage (``GeoServer._prepare_batch``:
    routing + cache lookup/learn) on each micro-batch *in arrival
    order* before dispatching it round-robin to a replica queue.
  * **replicas** (``n_replicas`` workers): each drains its dispatch
    queue through the DEVICE stage (``GeoServer._complete_batch``:
    padded engine assigns + ticket fills).  Replicas share the server's
    immutable region indices and launch the same kernels concurrently,
    each on its thread's current stream (the device's default stream: a
    stream per replica would need ``record_stream`` discipline in the
    caching allocator); a multi-device deployment would pin each
    worker's engines to its own device at this seam.

Why output is bit-identical to the synchronous server (and to direct
``engine.assign``): the host stage is serialized in the flusher, so the
cache's hit/miss/learn sequence — the only stateful, order-sensitive
part of serving — is deterministic in enqueue order; the device stage
computes a pure function of each batch; and tickets preallocate their
result arrays so parts merge in ticket order (disjoint row ranges)
whatever the replica completion order.  GeoStats merges are sums, hence
order-free.  See DESIGN.md §14 for the lock boundaries.

Failure recovery extends the sync server's requeue contract: a replica
whose batch dies requeues the drained-but-unserved slices at the queue
front (FIFO preserved, atomic under the batcher lock) and the work
retries on a later flush — but each ticket carries a retry budget
(``max_retries``), after which its future fails with the engine's
exception instead of crash-looping.  A CUDA error is sticky (every
later launch in the process fails too), so such a batch spends its
budget and its futures fail; nothing falls back to the CPU.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional

import numpy as np

from repro_torch.core.engine import EngineConfig, GeoEngine
from repro_torch.core.geometry import CensusMap
from repro_torch.serving.batcher import QueueFull
from repro_torch.serving.server import (GeoServer, ServeConfig,
                                        ServeResult, _Ticket)

__all__ = ["AsyncGeoServer", "FrontendConfig"]


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Static front-end knobs (threading shape + flush policy)."""

    n_submitters: int = 4        # client-facing enqueue pool
    n_replicas: int = 1          # engine workers draining the batcher
    flush_points: Optional[int] = None   # size trigger; None = top bucket
    max_delay_ms: float = 2.0    # deadline when ServeConfig has none
    idle_tick_s: float = 0.01    # flusher wakeup cadence when idle
    max_retries: int = 2         # per-ticket failed-flush budget
    put_timeout_s: float = 0.05  # blocked-put poll (shutdown liveness)


class _FutureTicket(_Ticket):
    """A ticket whose completion resolves a ``concurrent.futures.Future``
    — the async front-end's per-request handle.  ``retries`` counts the
    failed flushes this ticket has survived (see ``_recover_batch``)."""

    __slots__ = ("future", "retries")

    def __init__(self, n: int, t0: float, trace=None):
        super().__init__(n, t0, trace=trace)
        self.future: Future = Future()
        self.retries = 0
        if n == 0:                       # trivially complete, like sync
            self.future.set_result(self.result())

    def _completed(self) -> None:
        # A late part of an already-failed (retry-exhausted) ticket may
        # still serve; the future keeps its exception.
        if not self.future.done():
            self.future.set_result(self.result())

    def fail(self, exc: BaseException) -> None:
        if not self.future.done():
            self.future.set_exception(exc)
        if self.trace is not None:       # shed/failed requests still close
            self.trace.end(error=type(exc).__name__)  # — never orphans


class AsyncGeoServer(GeoServer):
    """Concurrent front-end over the GeoServer machinery (see module
    docstring).  Accepts the same engines/config as ``GeoServer`` plus a
    ``FrontendConfig``; serving starts immediately on construction and
    stops at ``close()`` (or context-manager exit)."""

    def __init__(self, engines, cfg: Optional[ServeConfig] = None, *,
                 covering=None, frontend: Optional[FrontendConfig] = None,
                 tracer=None):
        super().__init__(engines, cfg, covering=covering, tracer=tracer)
        f = frontend or FrontendConfig()
        if f.n_submitters < 1 or f.n_replicas < 1:
            raise ValueError(f"n_submitters and n_replicas must be >= 1, "
                             f"got {f.n_submitters}/{f.n_replicas}")
        self.fcfg = f
        self._flush_points = (int(f.flush_points) if f.flush_points
                              else self.cfg.buckets[-1])
        self._deadline_ms = (self.cfg.max_delay_ms
                             if self.cfg.max_delay_ms is not None
                             else f.max_delay_ms)
        self._stop = threading.Event()        # no new submits / puts
        self._flush_stop = threading.Event()  # flusher exit (after drain)
        self._outstanding = 0                 # accepted, unresolved tickets
        self._idle = threading.Condition()
        self._dispatch_lock = threading.Lock()
        self._seq = 0                         # round-robin batch counter
        self._submitters = ThreadPoolExecutor(
            f.n_submitters, thread_name_prefix="geo-submit")
        self._replica_queues: list[queue.Queue] = \
            [queue.Queue() for _ in range(f.n_replicas)]
        self._replicas = [
            threading.Thread(target=self._replica_loop, args=(ix,),
                             name=f"geo-replica-{ix}", daemon=True)
            for ix in range(f.n_replicas)]
        for t in self._replicas:
            t.start()
        self._flusher = threading.Thread(target=self._flush_loop,
                                         name="geo-flush", daemon=True)
        self._flusher.start()

    @classmethod
    def build(cls, census: CensusMap, strategy: str = "fast",
              cfg: Optional[ServeConfig] = None,
              engine_cfg: Optional[EngineConfig] = None,
              frontend: Optional[FrontendConfig] = None,
              tracer=None, *, device="cuda") -> "AsyncGeoServer":
        """Single-region convenience, mirroring ``GeoServer.build``: the
        engine is built on ``device``."""
        engine = GeoEngine.build(census, strategy,
                                 engine_cfg or EngineConfig(),
                                 device=device)
        return cls(engine, cfg, frontend=frontend, tracer=tracer)

    # -- client surface ----------------------------------------------------

    def submit_async(self, points) -> Future:
        """Queue one request; returns a Future resolving to its
        ``ServeResult``.  Never blocks the caller: backpressure either
        waits inside a submitter thread ("block") or fails the future
        with ``QueueFull`` ("shed").  Raises RuntimeError after
        ``close()``."""
        if self._stop.is_set():
            raise RuntimeError("AsyncGeoServer is closed")
        points = np.asarray(points, np.float32).reshape(-1, 2)
        t0 = time.perf_counter()
        ticket = _FutureTicket(len(points), t0,
                               trace=self._start_trace(t0))
        self.metrics.inc("requests")
        self.metrics.inc("points_in", len(points))
        with self._idle:
            self._outstanding += 1
        ticket.future.add_done_callback(self._request_resolved)
        if len(points):
            self._submitters.submit(self._enqueue_async, ticket, points)
        return ticket.future

    def submit(self, points, timeout: Optional[float] = None
               ) -> ServeResult:
        """Synchronous round trip through the concurrent pipeline."""
        return self.submit_async(points).result(timeout)

    def enqueue(self, points):
        raise NotImplementedError(
            "AsyncGeoServer is future-based: use submit_async()/submit() "
            "(the sync GeoServer keeps enqueue/flush/poll)")

    # -- lifecycle ---------------------------------------------------------

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every accepted request has resolved (served, shed,
        or failed); False if ``timeout`` elapsed first.  Nudges the
        flusher so sub-deadline stragglers go out immediately."""
        deadline = None if timeout is None \
            else time.perf_counter() + timeout
        with self._idle:
            while self._outstanding:
                if len(self.batcher):
                    self._dispatch_flush()
                remaining = 0.05 if deadline is None \
                    else min(0.05, deadline - time.perf_counter())
                if remaining <= 0:
                    return False
                self._idle.wait(remaining)
        return True

    def close(self, timeout: float = 30.0) -> None:
        """Stop accepting work, serve everything queued, stop the
        threads.  Idempotent.  Requests still waiting for queue room
        when close() lands fail with QueueFull."""
        if self._stop.is_set():
            return
        self._stop.set()                  # reject new submits; unblock puts
        self._submitters.shutdown(wait=True)
        self._flush_stop.set()            # flusher: final drain, then exit
        self._flusher.join(timeout)
        for q in self._replica_queues:    # sentinel after all dispatches
            q.put(None)
        for t in self._replicas:
            t.join(timeout)

    def __enter__(self) -> "AsyncGeoServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- pipeline threads --------------------------------------------------

    def _request_resolved(self, fut: Future) -> None:
        with self._idle:
            self._outstanding -= 1
            self._idle.notify_all()

    def _enqueue_async(self, ticket: _FutureTicket,
                       points: np.ndarray) -> None:
        """Submitter-pool body: blocking put with shutdown liveness."""
        try:
            # The submit span's end is stamped BEFORE the put: once the
            # put lands, the flusher may serve and close the trace ahead
            # of this thread resuming, and a post-put timestamp could
            # fall outside the root interval (child-nests-in-parent is
            # the exported invariant).  The blocked-put wait itself is
            # queue_wait's job, not submit's.
            t_put = time.perf_counter()
            while not self.batcher.put(ticket, points, wait=True,
                                       timeout=self.fcfg.put_timeout_s):
                if self._stop.is_set():
                    raise QueueFull("AsyncGeoServer closed while waiting "
                                    "for queue room")
                t_put = time.perf_counter()
        except QueueFull as e:
            self.metrics.inc("shed_requests")
            self.metrics.inc("shed_points", len(points))
            ticket.fail(e)
        except BaseException as e:        # never lose a future
            ticket.fail(e)
        else:
            if ticket.trace is not None:  # submit = client call -> queued
                ticket.trace.span("submit", ticket._t0, t_put,
                                  n_points=len(points))
            self._update_queue_gauges()

    def _flush_loop(self) -> None:
        while not self._flush_stop.is_set():
            if not self.batcher.wait_for_work(
                    timeout=self.fcfg.idle_tick_s):
                continue
            age_ms = self.batcher.oldest_age_s() * 1e3
            if self.batcher.queued_points >= self._flush_points:
                self._dispatch_flush()
            elif age_ms >= self._deadline_ms:
                self.metrics.inc("deadline_flushes")
                self._dispatch_flush()
            else:                         # coalesce until a trigger fires
                wait_s = min((self._deadline_ms - age_ms) / 1e3,
                             self.fcfg.idle_tick_s)
                time.sleep(max(wait_s, 1e-4))
        self._dispatch_flush()            # close(): serve the leftovers

    def _dispatch_flush(self) -> int:
        """Drain + host stage (in order) + round-robin dispatch; returns
        micro-batches dispatched.  Serialized so two callers (flusher +
        drain()/flush()) cannot interleave the host stage — arrival-order
        cache determinism is the bit-identity contract."""
        with self._dispatch_lock:
            batches = self.batcher.drain()
            for mb in batches:
                work = self._prepare_batch(mb)
                q = self._replica_queues[
                    self._seq % len(self._replica_queues)]
                self._seq += 1
                q.put(work)
        if batches:
            self._update_queue_gauges()
        return len(batches)

    def flush(self) -> int:
        """Force-dispatch everything queued (does not wait for the
        replicas to finish — ``drain()`` does)."""
        return self._dispatch_flush()

    def poll(self) -> int:
        """Deadline tick, for symmetry with the sync server (the flusher
        thread already does this continuously)."""
        if not len(self.batcher) \
                or self.batcher.oldest_age_s() * 1e3 < self._deadline_ms:
            return 0
        self.metrics.inc("deadline_flushes")
        return self._dispatch_flush()

    def _replica_loop(self, ix: int) -> None:
        q = self._replica_queues[ix]
        while True:
            work = q.get()
            if work is None:
                return
            try:
                self._complete_batch(work)
            except Exception as exc:      # device/engine failure
                self._recover_batch(work, exc)
            finally:
                if any(r.cache is not None for r in self.regions):
                    self.metrics.observe_cache(self.cache_snapshot())

    def _recover_batch(self, work, exc: Exception) -> None:
        """The async spelling of the sync server's requeue-on-failure:
        every slice of the failed batch goes back to the queue FRONT in
        order — unless its ticket has exhausted ``max_retries``, in
        which case that request's future fails with the engine's
        exception (a poisoned batch must not crash-loop the replica)."""
        self.metrics.inc("failed_flushes")
        entries, dead, bumped = [], [], set()
        for (t, ro, bo, ln) in work.mb.parts:
            if id(t) not in bumped:
                bumped.add(id(t))
                t.retries += 1
                t.attempt = t.retries     # later spans carry the attempt
                if t.retries > self.fcfg.max_retries:
                    dead.append(t)
                elif t.trace is not None:
                    t.trace.event("retry", attempt=t.attempt)
            if t.retries <= self.fcfg.max_retries:
                entries.append((t, work.mb.points[bo:bo + ln], ro))
        for t in dead:
            self.metrics.inc("failed_requests")
            t.fail(exc)                   # fail() also closes the trace
        if entries:
            self.batcher.requeue(entries)

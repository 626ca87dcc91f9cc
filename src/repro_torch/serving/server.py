"""GeoServer: the streaming geo-assignment serving facade (port of
src/repro/serving/server.py; DESIGN.md §10).

Turns one or more ``GeoEngine``s into an online service over a request
stream:

    server = GeoServer.build(census, strategy="hybrid")   # on cuda
    server.warm()                         # pre-pay every bucket's first run
    res = server.submit(points)           # [n, 2] -> ServeResult
    print(server.metrics.to_json())       # live counters / latency

The pieces (each its own module, composable without the facade):

  * ``batcher.MicroBatcher``  — bounded FIFO queue; coalesces requests
    into micro-batches padded up the bucket ladder so each engine sees
    a handful of shapes, with block/shed backpressure.  Flushes
    fire on ``submit``, on the size trigger (block policy), and — when
    ``ServeConfig.max_delay_ms`` is set — on a time deadline
    (``poll()``), so latency SLOs hold under trickle traffic;
  * ``cache.HotCellCache``    — exact host-side hot-cell shortcut for
    interior-cell traffic, full-engine fallback for everything else;
  * ``metrics.ServerMetrics`` — counters/gauges/latency registry
    (``phase2_miss`` et al. surfaced per the ROADMAP serving item).

**Multi-region routing**: pass a list of engines (one per regional index
— the production shape where no single host holds the national index)
and ``submit`` routes each point to its owning region via the engines'
extent masks (PR 2's ``extent_mask``, exposed through
``GeoEngine.extent_contains``).  Ownership is deterministic: the first
region (list order) whose extent contains the point wins, so a point on
a shared border resolves identically on every submit.  Points in no
region's extent come back -1 with ``region == -1`` (true for the
single-engine server too — extents cover all map geometry, so the
engine's own answer for such points is -1 anyway and they skip the
device).  Results merge back in input order whatever the routing.

Bit-identity contract: with the cache off, every served point's
(state, county, block) equals a direct ``engine.assign`` on the owning
engine — padding is FAR-neutralized, coalescing never reorders results.
With the cache on the same holds for every exact engine configuration
(see cache.py for the interior-cell argument and the overflow caveat).

This facade's serving loop is synchronous and single-threaded — the unit
of concurrency here is the device batch.  The serve path keeps the
reference's two stages (``_prepare_batch`` — routing + cache, ordered;
``_complete_batch`` — engine assigns), which its concurrent front-end
(``frontend.AsyncGeoServer``) dispatches to replica workers.

Device tensors: routing, the cache and the analytics windows run on the
host (numpy); each region's padded assign runs on its engine's device
and only the [bucket] id rows come back.  ``GeoServer.from_artifact``
cold-starts a server from a saved ``GeoIndexSet`` (no covering build).
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.analytics import AnalyticsConfig, WindowedAggregator
from repro_torch.core.artifact import GeoIndexSet
from repro_torch.core.cells import build_cell_covering
from repro_torch.core.engine import EngineConfig, GeoEngine
from repro_torch.core.fast import np_extent_mask, np_quantize_codes
from repro_torch.core.geometry import CensusMap, polygon_areas
from repro_torch.core.resolve import GeoStats
from repro_torch.obs import profile as obs_profile
from repro_torch.obs.trace import Tracer
from repro_torch.serving.batcher import (DEFAULT_BUCKETS, MicroBatch,
                                         MicroBatcher, QueueFull,
                                         bucket_for, pad_points)
from repro_torch.serving.cache import CellTable, HotCellCache
from repro_torch.serving.metrics import ServerMetrics


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Static serving knobs."""

    buckets: tuple = DEFAULT_BUCKETS   # micro-batch padding ladder
    max_queue_points: int = 1 << 16    # backpressure bound
    policy: str = "block"              # "block" | "shed" (batcher.py)
    cache: bool = True                 # hot-cell cache (cache.py)
    cache_capacity: int = 1 << 16      # LRU entries per region
    latency_window: int = 4096         # latency percentile sample window
    max_delay_ms: Optional[float] = None  # flush deadline: oldest queued
    #                                       request older than this
    #                                       triggers a flush (enqueue
    #                                       checks it; timers call
    #                                       ``poll()``) so trickle
    #                                       traffic still meets latency
    #                                       SLOs instead of waiting for
    #                                       the size trigger.  None =
    #                                       size/submit-driven only.
    trace_device: bool = False         # wrap device-stage assigns in a
    #                                    torch.profiler range (+ NVTX on
    #                                    the card) so a captured trace
    #                                    (start_profile/stop_profile)
    #                                    names each region/bucket range
    #                                    (DESIGN.md §15).
    analytics: Optional[AnalyticsConfig] = None  # opt-in windowed
    #                                    streaming analytics: every served
    #                                    batch also feeds a per-region
    #                                    WindowedAggregator (occupancy /
    #                                    encounters / k-anon suppression —
    #                                    DESIGN.md §16); read via
    #                                    ``snapshot_analytics()``.


@dataclasses.dataclass
class ServeResult:
    """Per-request outcome, rows in input order.  ``region`` is the index
    of the owning engine (-1 = in no region's extent); ids are that
    region's local (state, county, block) ids, -1 = not on its map."""

    state: np.ndarray
    county: np.ndarray
    block: np.ndarray
    region: np.ndarray
    latency_s: float


class _Ticket:
    """One in-flight request: preallocated result arrays filled as its
    micro-batch parts complete (a request can span batches — and under
    a concurrent front-end those batches can complete on different
    replica threads, so the remaining-count bookkeeping is lock-guarded and
    ``fill`` reports completion atomically: exactly one filler sees
    True).  Different parts write disjoint row ranges, so the array
    writes themselves need no lock.

    Tracing rides on the ticket (DESIGN.md §15): ``trace`` is the
    request's ``RequestTrace`` (None = unsampled — the whole request
    records nothing), ``enqueue_ts`` is the queue-wait clock the
    batcher re-stamps on every put/requeue (``mark_enqueued``), and
    ``attempt`` counts failed-flush retries so a retried request's
    spans stay distinguishable."""

    __slots__ = ("state", "county", "block", "region", "_remaining",
                 "_t0", "_lock", "latency_s", "trace", "enqueue_ts",
                 "attempt", "seq")

    # Process-wide request sequence: the analytics layer's *source
    # identity* — two points from the same submit share a seq, so
    # per-block distinct-source counts read "distinct requests", the
    # encounter/co-location unit (DESIGN.md §16).
    _seq = itertools.count()

    def __init__(self, n: int, t0: float, trace=None):
        self.seq = next(_Ticket._seq)
        self.state = np.full(n, -1, np.int32)
        self.county = np.full(n, -1, np.int32)
        self.block = np.full(n, -1, np.int32)
        self.region = np.full(n, -1, np.int32)
        self._remaining = n            # guarded-by: _lock
        self._t0 = t0
        self._lock = threading.Lock()
        self.latency_s = 0.0 if n == 0 else None  # guarded-by: _lock
        self.trace = trace
        self.enqueue_ts = t0
        self.attempt = 0
        if n == 0 and trace is not None:   # trivially complete
            trace.end(t0, n_points=0)

    def mark_enqueued(self) -> None:
        """Batcher hook: the ticket just (re-)entered the queue — its
        queue-wait interval starts now."""
        self.enqueue_ts = time.perf_counter()

    def fill(self, req_off: int, length: int, sid, cid, bid,
             region) -> bool:
        """Write one served part; True exactly once, when this part
        completes the request (the caller owning that True observes the
        latency / resolves the future)."""
        sl = slice(req_off, req_off + length)
        self.state[sl] = sid
        self.county[sl] = cid
        self.block[sl] = bid
        self.region[sl] = region
        with self._lock:
            self._remaining -= length
            if self._remaining != 0:
                return False
            self.latency_s = time.perf_counter() - self._t0
        self._completed()
        return True

    def _completed(self) -> None:
        """Completion hook — a concurrent front-end's future ticket
        resolves its Future here; the sync ticket needs nothing."""

    @property
    def done(self) -> bool:
        with self._lock:
            return self._remaining == 0

    def result(self) -> ServeResult:
        if not self.done:
            raise RuntimeError("request not fully served yet — flush()")
        return ServeResult(self.state, self.county, self.block,
                           self.region, self.latency_s)


@dataclasses.dataclass
class _Region:
    """One hosted engine plus its host-side serving companions (quant
    and parent tables snapshotted once at construction — the routing /
    cache-hit hot paths never touch the device)."""

    engine: GeoEngine
    quant: np.ndarray                     # [4] f32, host snapshot
    max_level: int
    block_parent: np.ndarray
    county_parent: np.ndarray
    cache: Optional[HotCellCache]
    analytics: Optional[WindowedAggregator] = None  # ServeConfig.analytics
    stats: Optional[GeoStats] = None      # guarded-by: lock
    # Guards the stats merge — replica workers can finish two of this
    # region's batches at once (GeoStats.merge is a sum, so merge order
    # never matters, only merge atomicity).
    lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False)

    def host_parents_of(self, bid: np.ndarray):
        """(state, county) from block ids — cache hits only: hits are
        interior cells, so bid >= 0 and the derivation is complete.
        Engine misses keep the engine's own state/county instead (the
        cascade can resolve a state yet lose the block — see
        _serve_region)."""
        cid = np.where(bid >= 0,
                       self.block_parent[np.clip(bid, 0, None)], -1)
        sid = np.where(cid >= 0,
                       self.county_parent[np.clip(cid, 0, None)], -1)
        return sid.astype(np.int32), cid.astype(np.int32)


@dataclasses.dataclass
class _BatchWork:
    """One micro-batch between the host stage and the device stage:
    routing + cache hits already resolved (in arrival order), engine
    work still pending.  A concurrent front-end's unit of dispatch."""

    mb: MicroBatch
    owner: np.ndarray               # [n] i32 owning region per point
    sid: np.ndarray                 # [n] i32, cache hits filled, else -1
    cid: np.ndarray
    bid: np.ndarray
    device: list                    # [(region_ix, sel rows, miss rows)]
    ats: float = 0.0                # analytics event time, stamped in
    #                                 the (ordered) host stage
    src: Optional[np.ndarray] = None  # [n] i64 source id (request seq)
    #                                 per point, None = analytics off


class GeoServer:
    """Streaming serving facade over one or more GeoEngines (see module
    docstring)."""

    def __init__(self, engines: Union[GeoEngine, Sequence[GeoEngine]],
                 cfg: Optional[ServeConfig] = None, *, covering=None,
                 tracer: Optional[Tracer] = None):
        """``covering`` optionally provides the covering(s) the hot-cell
        cache needs (one, or one per engine) — for engines without one
        (strategy "simple") it is otherwise built from the engine's
        census, a one-time host build.  ``tracer`` (obs/trace.py) opts the
        server into per-request span recording at the tracer's sample
        rate; the per-stage latency histograms in ``metrics`` are
        always on, tracer or not."""
        self.cfg = cfg or ServeConfig()
        self.tracer = tracer
        if isinstance(engines, GeoEngine):
            engines = [engines]
        if not engines:
            raise ValueError("GeoServer needs at least one engine")
        coverings = covering if isinstance(covering, (list, tuple)) \
            else [covering] * len(engines)
        if len(coverings) != len(engines):
            raise ValueError("covering list must match engines")
        self._analytics_on = self.cfg.analytics is not None
        self.regions = [self._make_region(e, c)
                        for e, c in zip(engines, coverings)]
        self.metrics = ServerMetrics(self.cfg.latency_window)
        # Surface each region's built index footprint (edge-pool bytes,
        # chosen pool block size, ...) so operators see what the tile
        # autotune actually costs in device memory.
        for r_ix, region in enumerate(self.regions):
            self.metrics.observe_footprint(
                f"region{r_ix}_",
                region.engine.indices.memory_footprint())
        self.batcher = MicroBatcher(self.cfg.buckets,
                                    self.cfg.max_queue_points,
                                    self.cfg.policy)

    def _make_region(self, engine: GeoEngine, covering) -> _Region:
        block_parent, county_parent = engine.host_parents()
        cache = None
        if self.cfg.cache:
            cov = covering if covering is not None else engine.covering
            if cov is None:
                if engine.census is None:
                    raise ValueError(
                        "the hot-cell cache needs a covering: pass "
                        "covering=, build the engine from a census, or "
                        "serve with ServeConfig(cache=False)")
                cov = build_cell_covering(engine.census,
                                          max_level=engine.cfg.max_level,
                                          max_cand=engine.cfg.max_cand)
            cache = HotCellCache(CellTable.from_covering(cov),
                                 self.cfg.cache_capacity)
        quant, max_level = engine.extent_quant()
        analytics = None
        if self._analytics_on:
            areas = polygon_areas(engine.census.blocks) \
                if engine.census is not None else None
            analytics = WindowedAggregator(len(block_parent),
                                           self.cfg.analytics, areas)
        return _Region(engine, quant, max_level, block_parent,
                       county_parent, cache, analytics=analytics)

    @classmethod
    def build(cls, census: CensusMap, strategy: str = "fast",
              cfg: Optional[ServeConfig] = None,
              engine_cfg: Optional[EngineConfig] = None, *,
              device="cuda") -> "GeoServer":
        """Single-region convenience: build the engine on ``device`` and
        serve it (``strategy="auto"`` lets the planner choose — see
        core/plan.py)."""
        engine = GeoEngine.build(census, strategy,
                                 engine_cfg or EngineConfig(),
                                 device=device)
        return cls(engine, cfg)

    @classmethod
    def from_artifact(cls, path: str, strategy: str = "auto",
                      cfg: Optional[ServeConfig] = None,
                      engine_cfg: Optional[EngineConfig] = None, *,
                      device="cuda") -> "GeoServer":
        """Cold start from a saved ``GeoIndexSet`` artifact
        (core/artifact.py) on ``device``: the covering is read from disk
        instead of rebuilt, the device indices are rebuilt from the saved
        arrays, and the served ids equal those of the engine that saved
        it.  ``strategy="auto"`` replans against the loaded capabilities
        and the artifact's tuning record."""
        indices = GeoIndexSet.load(path, device=device)
        engine = GeoEngine.from_index_set(indices, strategy, engine_cfg)
        return cls(engine, cfg, covering=indices.covering)

    # -- lifecycle ---------------------------------------------------------

    def warm(self, buckets: Optional[Sequence[int]] = None) -> dict:
        """Run an all-padding batch of every bucket through every engine,
        to completion; returns bucket -> wall seconds (the first call
        pays the kernel build and the allocator's first blocks, later
        ones ~0).  Call before taking traffic so no live request pays
        them."""
        times = {}
        for bucket in buckets or self.cfg.buckets:
            t0 = time.perf_counter()
            for region in self.regions:
                dev = region.engine.device
                zeros = torch.zeros((int(bucket), 2), dtype=torch.float32,
                                    device=dev)
                region.engine.assign_padded(zeros, 0)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            times[int(bucket)] = time.perf_counter() - t0
            self.metrics.inc("warm_batches")
        return times

    # -- request path ------------------------------------------------------

    def _start_trace(self, t0: float):
        """Head-sampled RequestTrace for a new request (None = tracer
        absent or this request not sampled)."""
        return None if self.tracer is None else self.tracer.start_trace(t0)

    def enqueue(self, points) -> _Ticket:
        """Queue one request ([n, 2] lon/lat); returns its ticket.  Under
        the "shed" policy a full queue raises QueueFull (counted); under
        "block" it triggers an inline flush to make room."""
        points = np.asarray(points, np.float32).reshape(-1, 2)
        t0 = time.perf_counter()
        ticket = _Ticket(len(points), t0, trace=self._start_trace(t0))
        self.metrics.inc("requests")
        self.metrics.inc("points_in", len(points))
        if len(points) == 0:
            return ticket                  # trivially complete
        try:
            accepted = self.batcher.put(ticket, points)
        except QueueFull:
            self.metrics.inc("shed_requests")
            self.metrics.inc("shed_points", len(points))
            if ticket.trace is not None:   # shed atomically: root closes,
                ticket.trace.end(error="QueueFull")  # no orphan children
            raise
        if not accepted:                   # "block": serve-now, then queue
            self.flush()
            self.batcher.put(ticket, points)
        if ticket.trace is not None:
            ticket.trace.span("submit", t0, time.perf_counter(),
                              n_points=len(points))
        self._update_queue_gauges()
        # Deadline trigger rides the arrival path too: a trickle of tiny
        # requests must not wait for the size trigger (idle gaps are the
        # timer's job — ``poll()``).
        self.poll()
        return ticket

    def submit(self, points) -> ServeResult:
        """Synchronous round trip: enqueue + flush + result."""
        ticket = self.enqueue(points)
        if not ticket.done:
            self.flush()
        return ticket.result()

    def poll(self) -> int:
        """Deadline tick (``ServeConfig.max_delay_ms``): flush when the
        oldest queued request has waited past the deadline; returns
        micro-batches served (0 = nothing due).  ``enqueue`` calls this
        on every arrival; an async front-end or timer loop calls it in
        idle gaps so the last trickle request is never stranded.
        Deadline-triggered flushes are counted in ``deadline_flushes``
        (metrics) so SLO pressure is visible next to the size trigger."""
        if self.cfg.max_delay_ms is None or not len(self.batcher):
            return 0
        if self.batcher.oldest_age_s() * 1e3 < self.cfg.max_delay_ms:
            return 0
        self.metrics.inc("deadline_flushes")
        return self.flush()

    def flush(self) -> int:
        """Drain the queue through the engines; returns micro-batches
        served.  Flushing an empty queue is a no-op.  If serving dies
        mid-flush (device error in one engine), every drained-but-
        unserved batch — including the failed one, whose tickets are
        untouched until the batch completes — is requeued at the front
        of the queue, so no request is lost: the exception propagates
        and a later flush() retries."""
        batches = self.batcher.drain()
        served = 0
        try:
            for mb in batches:
                self._serve_batch(mb)
                served += 1
        finally:
            if served < len(batches):
                entries = [(t, mb.points[bo:bo + ln], ro)
                           for mb in batches[served:]
                           for (t, ro, bo, ln) in mb.parts]
                self._note_retries(t for t, _, _ in entries)
                self.batcher.requeue(entries)
                self.metrics.inc("failed_flushes")
            if served and any(r.cache is not None for r in self.regions):
                # Keep cache_* counters fresh so metrics.snapshot()/
                # to_json() is accurate without GeoServer.snapshot().
                self.metrics.observe_cache(self.cache_snapshot())
            self._update_queue_gauges()
        return len(batches)

    def _update_queue_gauges(self) -> None:
        self.metrics.set_gauge("queue_depth_points",
                               self.batcher.queued_points)
        self.metrics.set_gauge("queue_depth_requests", len(self.batcher))

    def _note_retries(self, tickets) -> None:
        """Bump every distinct ticket's attempt counter and record a
        linked ``retry`` span (parent = the request's root) — a retried
        request's later spans carry the new attempt number, so its
        timeline reads attempt-by-attempt."""
        seen = set()
        for t in tickets:
            if id(t) in seen:
                continue
            seen.add(id(t))
            t.attempt += 1
            if t.trace is not None:
                t.trace.event("retry", attempt=t.attempt)

    # -- serving internals -------------------------------------------------

    def _route(self, pts: np.ndarray) -> np.ndarray:
        """Owning region per point: first region (list order) whose
        extent contains it — deterministic on shared/overlapping borders;
        -1 when no extent matches (single- and multi-region alike, so
        ``region == -1`` always means "in no region's extent").  Unowned
        points skip the device and answer -1 directly — result-identical
        to asking an engine, since the extent covers all of its map
        geometry and every strategy rejects off-extent points (PR 2)."""
        owner = np.full(len(pts), -1, np.int32)
        for r_ix, region in enumerate(self.regions):
            inside = np_extent_mask(region.quant, region.max_level, pts)
            owner = np.where((owner < 0) & inside, r_ix, owner)
        return owner

    def _serve_batch(self, mb: MicroBatch) -> None:
        self._complete_batch(self._prepare_batch(mb))

    def _prepare_batch(self, mb: MicroBatch) -> "_BatchWork":
        """HOST stage, run in arrival order: route every point to its
        region, resolve cache hits, and *learn* the eligible miss codes
        — learning needs only the covering table, never the engine
        result, so it can (and must, for determinism) happen here.  The
        async front-end runs this stage single-threaded in its flusher,
        which is what keeps the cache's hit/miss/learn sequence — and
        with it the set of device-served points and the merged GeoStats
        — identical to the synchronous server's for the same request
        order (DESIGN.md §14).

        Observability (§15): the stage interval feeds the
        ``host_prepare``/``queue_wait`` histograms per batch, and every
        *sampled* ticket in the batch gets queue_wait + host_prepare
        spans (children: route, per-region cache_lookup/cache_learn) —
        the whole batch shares one timing, each sampled request records
        its own copy so per-request timelines stay self-contained."""
        tp0 = time.perf_counter()
        pts = mb.points
        n = len(pts)
        owner = self._route(pts)
        tr1 = time.perf_counter()
        sid = np.full(n, -1, np.int32)
        cid = np.full(n, -1, np.int32)
        bid = np.full(n, -1, np.int32)
        device = []
        sub = [("route", tp0, tr1, {})]    # host_prepare sub-intervals
        for r_ix, region in enumerate(self.regions):
            sel = np.nonzero(owner == r_ix)[0]
            if not sel.size:
                continue
            rs, rc, rb, mi, rsub = self._host_stage(region, pts[sel],
                                                    r_ix)
            sub += rsub
            sid[sel], cid[sel], bid[sel] = rs, rc, rb
            if mi.size:
                device.append((r_ix, sel, mi))
        tp1 = time.perf_counter()
        self.metrics.observe_stage("host_prepare", tp1 - tp0)
        seen = set()
        for ticket, _, _, _ in mb.parts:
            if id(ticket) in seen:
                continue
            seen.add(id(ticket))
            # Snapshot the clock once: a concurrent requeue (another
            # part of this ticket failing on a replica) may restamp
            # enqueue_ts past tp0 — clamp so the interval stays valid.
            enq = min(ticket.enqueue_ts, tp0)
            self.metrics.observe_stage("queue_wait", tp0 - enq)
            trace = ticket.trace
            if trace is None:
                continue
            attrs = {"attempt": ticket.attempt} if ticket.attempt else {}
            trace.span("queue_wait", enq, tp0, **attrs)
            host = trace.span("host_prepare", tp0, tp1, **attrs)
            for name, s0, s1, sattrs in sub:
                trace.span(name, s0, s1, parent=host, **sattrs, **attrs)
        ats, src = 0.0, None
        if self._analytics_on:
            # Analytics event time + source ids are stamped HERE, in the
            # host stage — sync flush and the async dispatcher both run
            # this stage serialized in arrival order, so a batch's window
            # membership is decided before replica threads race on
            # completion; the window folds themselves commute
            # (DESIGN.md §16).
            ats = self.cfg.analytics.clock()
            src = np.empty(n, np.int64)
            for ticket, _, batch_off, length in mb.parts:
                src[batch_off:batch_off + length] = ticket.seq
        return _BatchWork(mb, owner, sid, cid, bid, device, ats, src)

    def _host_stage(self, region: _Region, pts: np.ndarray, r_ix: int):
        """Cache lookup + learn for one region's slice of a batch;
        returns (state, county, block, miss_rows, sub_intervals) with
        hit rows filled and miss rows -1.  Off-extent points stay
        misses: the engine answers them -1, and their border-clipped
        codes must never touch the cache.  Cache hits are interior
        cells (block always >= 0), so the host parent tables give the
        complete exact answer.

        ``sub_intervals`` are (name, t0, t1, attrs) rows — the
        cache_lookup/cache_learn children of the batch's host_prepare
        span.  The monotonic ``cache_*_total`` counters increment here,
        at the observation site (per-point hits, per-eligible-probe
        misses, learn-returned insertions), so scrapers can diff them
        across cache clears without phantom negative deltas."""
        m = len(pts)
        sid = np.full(m, -1, np.int32)
        cid = np.full(m, -1, np.int32)
        bid = np.full(m, -1, np.int32)
        miss = np.ones(m, bool)
        if region.cache is None:
            return sid, cid, bid, np.nonzero(miss)[0], []
        tl0 = time.perf_counter()
        codes = np_quantize_codes(region.cache.table.quant,
                                  region.cache.table.max_level, pts)
        eligible = np_extent_mask(region.cache.table.quant,
                                  region.cache.table.max_level, pts)
        n_hit = 0
        n_eligible = int(eligible.sum())
        if n_eligible:
            el = np.nonzero(eligible)[0]
            cbid, hit = region.cache.lookup(codes[el])
            hit_rows = el[hit]
            n_hit = int(hit_rows.size)
            bid[hit_rows] = cbid[hit]
            sid[hit_rows], cid[hit_rows] = \
                region.host_parents_of(bid[hit_rows])
            miss[hit_rows] = False
        tl1 = time.perf_counter()
        self.metrics.inc("cache_hits_total", n_hit)
        self.metrics.inc("cache_misses_total", n_eligible - n_hit)
        sub = [("cache_lookup", tl0, tl1,
                {"region": r_ix, "rows": m, "hits": n_hit})]
        mi = np.nonzero(miss)[0]
        learnable = mi[eligible[mi]]
        if learnable.size:
            # The learned value comes from the covering's interior table,
            # not the engine — exact by the interior invariant, so
            # learning before the device assign changes nothing but
            # makes the host stage self-contained.
            inserted = region.cache.learn(codes[learnable])
            tn1 = time.perf_counter()
            self.metrics.inc("cache_insertions_total", inserted)
            sub.append(("cache_learn", tl1, tn1,
                        {"region": r_ix, "inserted": inserted}))
        return sid, cid, bid, mi, sub

    def _complete_batch(self, work: "_BatchWork") -> None:
        """DEVICE stage + result scatter: engine-assign every region's
        cache-miss rows, then fill tickets.  Order-free: the arrays it
        writes are disjoint per part and the stats/metrics folds are
        sums, so the async front-end dispatches whole ``_BatchWork``s to
        replica workers round-robin and results stay bit-identical
        whatever the completion order.

        Observability (§15): each region's padded assign feeds the
        ``device_assign`` histogram and — since a ticket only fills
        after *every* region of its batch served — each sampled ticket
        records every device interval of the batch.  The completing
        part additionally records the ``merge`` span and closes the
        request's root."""
        pts = work.mb.points
        dev = []                           # (t0, t1, attrs) per region
        for r_ix, sel, mi in work.device:
            region = self.regions[r_ix]
            td0 = time.perf_counter()
            rs, rc, rb = self._device_stage(region, pts[sel], mi)
            td1 = time.perf_counter()
            self.metrics.observe_stage("device_assign", td1 - td0)
            dev.append((td0, td1,
                        {"region": r_ix, "rows": int(mi.size),
                         "bucket": bucket_for(mi.size, self.cfg.buckets)}))
            work.sid[sel[mi]] = rs
            work.cid[sel[mi]] = rc
            work.bid[sel[mi]] = rb
        self.metrics.inc("batches")
        self.metrics.inc("points_served", len(pts))
        if work.src is not None:
            # Feed the windowed analytics before tickets fill: a synced
            # submit (or an async drain) then implies this batch's rows
            # are already folded into the aggregator — the served-vs-
            # direct equality tests hinge on that ordering.  Cache hits
            # and device answers feed alike; -1 rows count as off_map.
            ta0 = time.perf_counter()
            n_obs = 0
            for r_ix, region in enumerate(self.regions):
                if region.analytics is None:
                    continue
                sel = work.owner == r_ix
                if sel.any():
                    n_obs += region.analytics.observe(
                        work.ats, work.bid[sel], work.src[sel])
            self.metrics.inc("analytics_points", n_obs)
            self.metrics.observe_stage("analytics_observe",
                                       time.perf_counter() - ta0)
        if dev:
            seen = set()
            for ticket, _, _, _ in work.mb.parts:
                if ticket.trace is None or id(ticket) in seen:
                    continue
                seen.add(id(ticket))
                attrs = {"attempt": ticket.attempt} if ticket.attempt \
                    else {}
                for td0, td1, dattrs in dev:
                    ticket.trace.span("device_assign", td0, td1,
                                      **dattrs, **attrs)
        tm0 = time.perf_counter()
        for ticket, req_off, batch_off, length in work.mb.parts:
            bsl = slice(batch_off, batch_off + length)
            if ticket.fill(req_off, length, work.sid[bsl], work.cid[bsl],
                           work.bid[bsl], work.owner[bsl]):
                self.metrics.observe_latency(ticket.latency_s)
                if ticket.trace is not None:
                    done = time.perf_counter()
                    ticket.trace.span("merge", tm0, done)
                    ticket.trace.end(done, n_points=len(ticket.block))
        self.metrics.observe_stage("merge", time.perf_counter() - tm0)

    def _device_stage(self, region: _Region, pts: np.ndarray,
                      mi: np.ndarray):
        """One region's padded engine assign over its miss rows; returns
        (state, county, block) [len(mi)] i32.

        Miss rows keep the engine's own state/county — NOT a re-derivation
        from the block id: the cascade can resolve a point's state yet
        lose it at the county/block level (bbox gap, capacity overflow),
        and that partial answer must survive serving bit-identically."""
        bucket = bucket_for(mi.size, self.cfg.buckets)
        padded = pad_points(pts[mi], bucket)
        # Slot accounting at the device edge: this is the padding the
        # engine actually computes, post-cache and post-routing —
        # batch_fill_ratio measures real ladder waste.
        self.metrics.inc("padded_slots", bucket)
        self.metrics.inc("valid_slots", mi.size)
        engine = region.engine
        if self.cfg.trace_device:
            # Named profiler range so a captured device trace
            # (start_profile/stop_profile) attributes kernels to the
            # serving stage that launched them (DESIGN.md §15).
            with obs_profile.device_annotation(
                    f"geo_device_assign/b{bucket}", engine.device):
                res = engine.assign_padded(torch.from_numpy(padded),
                                           mi.size)
        else:
            res = engine.assign_padded(torch.from_numpy(padded), mi.size)
        with region.lock:
            region.stats = res.stats if region.stats is None \
                else region.stats.merge(res.stats)
        self.metrics.observe_geo(res.stats)
        # One device-to-host copy of the valid rows of all three ids.
        ids = torch.stack([res.state[:mi.size], res.county[:mi.size],
                           res.block[:mi.size]]).cpu().numpy()
        return ids[0], ids[1], ids[2]

    # -- introspection -----------------------------------------------------

    @property
    def stats(self) -> list:
        """Per-region merged GeoStats (None until that region served)."""
        return [r.stats for r in self.regions]

    def cache_snapshot(self) -> dict:
        """Aggregate hot-cell cache counters over all regions."""
        agg = {"entries": 0, "capacity": 0, "hits": 0, "misses": 0,
               "insertions": 0, "evictions": 0}
        for region in self.regions:
            if region.cache is not None:
                snap = region.cache.snapshot()
                for key in agg:
                    agg[key] += snap[key]
        probes = agg["hits"] + agg["misses"]
        agg["hit_rate"] = agg["hits"] / probes if probes else 0.0
        return agg

    def snapshot_analytics(self) -> Optional[dict]:
        """Per-region windowed-analytics snapshots (None = analytics
        off).  Also refreshes the ``analytics_*`` gauges, so a metrics
        scrape right after sees the same state.  Schema per region:
        ``WindowedAggregator.snapshot()`` (DESIGN.md §16)."""
        if not self._analytics_on:
            return None
        snaps = [r.analytics.snapshot() if r.analytics is not None
                 else None for r in self.regions]
        live = [s for s in snaps if s is not None]
        for gauge, key in (("analytics_open_panes", "open_panes"),
                           ("analytics_windows_finalized",
                            "finalized_total"),
                           ("analytics_late_dropped", "late_dropped"),
                           ("analytics_off_map_points", "off_map")):
            self.metrics.set_gauge(gauge, sum(s[key] for s in live))
        suppressed = 0
        for s in live:
            win = s["open"] or (s["finalized"][-1] if s["finalized"]
                                else None)
            if win is not None:
                suppressed += win["suppressed_blocks"]
        self.metrics.set_gauge("analytics_suppressed_blocks", suppressed)
        return {"regions": snaps}

    def snapshot(self) -> dict:
        """The live-metrics JSON snapshot (refreshes cache counters)."""
        self.metrics.observe_cache(self.cache_snapshot())
        self._update_queue_gauges()
        self.snapshot_analytics()
        return self.metrics.snapshot()

    def metrics_text(self) -> str:
        """Prometheus-style text exposition of the live registry
        (refreshes cache/queue/analytics gauges first) — ready to serve
        from a ``/metrics`` endpoint (DESIGN.md §15)."""
        if any(r.cache is not None for r in self.regions):
            self.metrics.observe_cache(self.cache_snapshot())
        self._update_queue_gauges()
        self.snapshot_analytics()
        return self.metrics.expose_text()

    def start_profile(self, logdir: str) -> bool:
        """Begin a ``torch.profiler`` capture for ``logdir`` (True if it
        started); pair with ``stop_profile``.  With
        ``ServeConfig(trace_device=True)`` each padded assign shows up
        as a named range in the capture."""
        return obs_profile.start_profile(logdir)

    def stop_profile(self) -> bool:
        """End the active capture and write its Chrome trace to
        ``<logdir>/trace.json`` (True if one stopped)."""
        return obs_profile.stop_profile()

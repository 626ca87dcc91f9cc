"""The port's concurrent front end (``repro_torch.serving.AsyncGeoServer``)
on the CPU, mirroring tests/test_frontend.py case by case: MicroBatcher
put/drain/requeue races, HotCellCache eviction under contention,
8-thread bit-identity with the port's synchronous server AND the JAX
package's (``backend="ref"``; cache on and off, one and two regions),
8 concurrent submitters, shed and block backpressure, the requeue and
retry budget, deadline flushes and lifecycle.  Tolerance: exact
equality (ids and counters are integers).

It also closes the runtime lock check's gap over the port (G1):
``repro.analysis.lockcheck`` instruments the port's serving, analytics
and tracing classes (their own ``# guarded-by:`` annotations), the
8-submitter and shed cases run under it, and no guarded write without
its lock and no acquisition-order cycle may show.

Every threaded test carries ``@pytest.mark.timeout`` (conftest's
thread-based deadline); the sustained-load soak is ``@pytest.mark.load``
and runs only under ``--run-load``.
"""
import contextlib
import dataclasses
import importlib
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest

from repro.analysis import lockcheck
from repro.core.engine import EngineConfig as JConfig
from repro.core.engine import GeoEngine as JEngine
from repro.core.synth import build_synth_census
from repro.serving import GeoServer as JServer
from repro.serving import ServeConfig as JServeConfig
from repro_torch.core.cells import CellCovering
from repro_torch.core.engine import EngineConfig, GeoEngine
from repro_torch.serving import (AsyncGeoServer, CellTable, FrontendConfig,
                                 GeoServer, HotCellCache, MicroBatcher,
                                 QueueFull, ServeConfig)

CAPS = dict(cap_state=1.0, cap_county=1.0, cap_block=1.0, cap_boundary=1.0,
            max_level=8)
BUCKETS = (64, 256, 1024)
# Mixed request sizes: singletons, coalescing, and top-bucket splits.
STREAM = (1, 7, 300, 555, 1024, 113)
# The port's classes of the DESIGN.md §14 lock table (the JAX package's
# ``lockcheck._TARGETS``, moved to repro_torch).
PORT_TARGETS = (
    ("repro_torch.serving.batcher", "MicroBatcher", ("_cond",)),
    ("repro_torch.serving.cache", "HotCellCache", ("_lock",)),
    ("repro_torch.serving.metrics", "ServerMetrics", ("_lock",)),
    ("repro_torch.serving.metrics", "LatencyWindow", ("_lock",)),
    ("repro_torch.serving.server", "_Ticket", ("_lock",)),
    ("repro_torch.serving.server", "_Region", ("lock",)),
    ("repro_torch.serving.frontend", "_FutureTicket", ()),
    ("repro_torch.serving.frontend", "AsyncGeoServer", ("_dispatch_lock",)),
    ("repro_torch.analytics.window", "WindowedAggregator", ("_lock",)),
    ("repro_torch.obs.trace", "SpanBuffer", ("_lock",)),
)


def _pair(census, strategy, **kw):
    """(JAX engine with backend ref, port engine on the CPU) over one
    covering."""
    j = JEngine.build(census, strategy, JConfig(backend="ref", **CAPS, **kw))
    t = GeoEngine.build(census, strategy, EngineConfig(**CAPS, **kw),
                        covering=CellCovering(**dataclasses.asdict(
                            j.covering)), device="cpu")
    return j, t


@pytest.fixture(scope="module")
def engines(synth_small):
    return _pair(synth_small.census, "fast", fused=True)


@pytest.fixture(scope="module")
def engine(engines):
    return engines[1]


@pytest.fixture(scope="module")
def two_regions_exact():
    """Two regional engine pairs with FULL caps: bit-identity across
    batch compositions needs overflow-free engines."""
    out = []
    for seed, extent in ((3, (-120.0, -100.0, 30.0, 45.0)),
                         (4, (-100.0, -80.0, 30.0, 45.0))):
        sc = build_synth_census(seed=seed, n_states=2, counties_per_state=2,
                                blocks_per_county=4, extent=extent)
        out.append((sc, *_pair(sc.census, "fast")))
    return out


def _region_stats(server):
    return [s.as_dict() if s is not None else None for s in server.stats]


# -- MicroBatcher under contention -------------------------------------------

@pytest.mark.timeout(60)
def test_batcher_stress_no_ticket_lost_or_duplicated():
    """N producers race put(wait=True) against a flusher that drains and
    sometimes requeues (a simulated failed flush): every ticket's rows
    serve exactly once, contiguously, in request order across a
    requeue."""
    b = MicroBatcher(buckets=BUCKETS, max_queue_points=512,
                     policy="block")
    n_producers, per_producer = 8, 40
    total = n_producers * per_producer
    sizes = {}
    served = []
    served_lock = threading.Lock()
    done = threading.Event()
    errors = []

    def producer(pid):
        rng = np.random.default_rng(100 + pid)
        try:
            for rix in range(per_producer):
                n = int(rng.integers(1, 150))
                t = (pid, rix)
                sizes[t] = n
                pts = np.full((n, 2), pid, np.float32)
                while not b.put(t, pts, wait=True, timeout=5.0):
                    if done.is_set():
                        raise RuntimeError("flusher died while blocked")
        except Exception as e:       # pragma: no cover - failure path
            errors.append(e)
            done.set()

    def flusher():
        rng = np.random.default_rng(7)
        requeues_left = 25
        try:
            while not done.is_set():
                if not b.wait_for_work(timeout=0.05):
                    continue
                for mb in b.drain():
                    if requeues_left > 0 and rng.uniform() < 0.3:
                        requeues_left -= 1
                        b.requeue([(t, mb.points[bo:bo + ln], ro)
                                   for (t, ro, bo, ln) in mb.parts])
                        continue
                    with served_lock:
                        served.extend((t, ro, ln)
                                      for (t, ro, _, ln) in mb.parts)
                with served_lock:
                    n_tickets = len({t for t, _, _ in served})
                if n_tickets == total and not len(b):
                    done.set()
        except Exception as e:       # pragma: no cover - failure path
            errors.append(e)
            done.set()

    threads = [threading.Thread(target=producer, args=(p,))
               for p in range(n_producers)]
    threads.append(threading.Thread(target=flusher))
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not errors, errors
    assert done.is_set() and not any(t.is_alive() for t in threads)
    coverage = {}
    order_ok = True
    last_off = {}
    for t, ro, ln in served:
        coverage.setdefault(t, []).append((ro, ln))
        order_ok &= ro >= last_off.get(t, 0)
        last_off[t] = ro
    assert order_ok
    assert len(coverage) == total
    for t, slices in coverage.items():
        slices.sort()
        pos = 0
        for ro, ln in slices:
            assert ro == pos, f"gap/overlap in {t}: {slices}"
            pos += ln
        assert pos == sizes[t], f"short serve of {t}"
    assert b.queued_points == 0


@pytest.mark.timeout(30)
def test_batcher_oldest_age_monotone_under_puts():
    """The deadline clock never moves backwards while the queue stays
    non-empty, whatever other producers do."""
    b = MicroBatcher(buckets=BUCKETS)
    b.put("anchor", np.zeros((2, 2), np.float32))
    stop = threading.Event()

    def churn():
        i = 0
        while not stop.is_set():
            b.put(("c", i), np.zeros((3, 2), np.float32))
            i += 1
            time.sleep(0.0005)

    t = threading.Thread(target=churn)
    t.start()
    try:
        last = 0.0
        for _ in range(200):
            age = b.oldest_age_s()
            assert age >= last
            last = age
    finally:
        stop.set()
        t.join(5)
    assert last > 0.0
    b.drain()
    assert b.oldest_age_s() == 0.0


# -- HotCellCache under contention -------------------------------------------

@pytest.mark.timeout(60)
def test_cache_eviction_under_contention():
    """8 threads hammer learn/lookup on a capacity-16 cache: entries never
    exceed capacity, every hit returns the exact interior value, eviction
    happens, and no counter update is lost."""
    n_codes = 256
    table = CellTable(lo=np.arange(n_codes, dtype=np.int32),
                      hi=np.arange(n_codes, dtype=np.int32),
                      val=(np.arange(n_codes, dtype=np.int32) * 3 + 1),
                      quant=np.zeros(4, np.float32), max_level=8)
    cache = HotCellCache(table, capacity=16)
    truth = table.interior_value(np.arange(n_codes, dtype=np.int32))
    probes = [0] * 8
    errors = []

    def worker(wid):
        rng = np.random.default_rng(wid)
        try:
            for _ in range(60):
                codes = rng.integers(0, n_codes, 32).astype(np.int32)
                cache.learn(codes)
                assert len(cache) <= 16
                bid, hit = cache.lookup(codes)
                probes[wid] += len(np.unique(codes))
                np.testing.assert_array_equal(bid[hit], truth[codes][hit])
                assert np.all(bid[~hit] == -1)
        except Exception as e:       # pragma: no cover - failure path
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(w,))
               for w in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not errors, errors
    assert len(cache) <= 16
    assert cache.evictions > 0
    assert cache.insertions - cache.evictions == len(cache)
    assert cache.hits + cache.misses == sum(probes)
    snap = cache.snapshot()
    assert snap["entries"] == len(cache)
    assert 0.0 <= snap["hit_rate"] <= 1.0


# -- bit-identity under concurrency ------------------------------------------

def _compare_streams(servers, async_server, xy, request_sizes):
    """Drive the same request stream through the synchronous servers
    (the port's and the JAX package's) and the async one: a sequential
    prewarm pass first, so every cache learns the same cells, then the
    measured phase through the async pipeline concurrently.  Per-request
    ids and merged per-region GeoStats must be equal."""
    for server in (*servers, async_server):
        server.submit(xy)
    reqs, off = [], 0
    for n in request_sizes:
        reqs.append(xy[off:off + n])
        off += n
    sync_res = [[server.submit(r) for r in reqs] for server in servers]
    futures = [async_server.submit_async(r) for r in reqs]
    assert async_server.drain(timeout=60)
    async_res = [f.result(timeout=5) for f in futures]
    for res in sync_res:
        for i, (s, a) in enumerate(zip(res, async_res)):
            for field in ("state", "county", "block", "region"):
                np.testing.assert_array_equal(
                    getattr(a, field), np.asarray(getattr(s, field)),
                    err_msg=f"request {i} field {field}")
    for server in servers:
        assert _region_stats(async_server) == _region_stats(server)


@pytest.mark.timeout(120)
@pytest.mark.parametrize("cache", [False, True])
def test_async_bit_identical_single_region(engines, points_small, cache):
    j_engine, engine = engines
    xy, *_ = points_small
    cfg = ServeConfig(buckets=BUCKETS, cache=cache)
    sync_server = GeoServer(engine, cfg)
    j_server = JServer(j_engine, JServeConfig(buckets=BUCKETS, cache=cache))
    with AsyncGeoServer(engine, cfg,
                        frontend=FrontendConfig(n_submitters=8,
                                                n_replicas=3)) as srv:
        _compare_streams((sync_server, j_server), srv, xy, STREAM)
        if cache:
            assert srv.cache_snapshot()["hits"] > 0
    direct = engine.assign(xy[:64])
    np.testing.assert_array_equal(sync_server.submit(xy[:64]).block,
                                  direct.block.numpy())


@pytest.mark.timeout(120)
@pytest.mark.parametrize("cache", [False, True])
def test_async_bit_identical_multi_region(two_regions_exact, cache):
    (scA, jA, tA), (scB, jB, tB) = two_regions_exact
    xyA, *_ = scA.sample_points(np.random.default_rng(21), 900)
    xyB, *_ = scB.sample_points(np.random.default_rng(22), 900)
    inter = np.empty((1800, 2), np.float32)
    inter[0::2], inter[1::2] = xyA, xyB
    cfg = ServeConfig(buckets=BUCKETS, cache=cache)
    sync_server = GeoServer([tA, tB], cfg)
    j_server = JServer([jA, jB], JServeConfig(buckets=BUCKETS, cache=cache))
    with AsyncGeoServer([tA, tB], cfg,
                        frontend=FrontendConfig(n_submitters=8,
                                                n_replicas=2)) as srv:
        _compare_streams((sync_server, j_server), srv, inter,
                         (13, 301, 555, 700, 231))


def _run_concurrent_submitters(engines, xy):
    j_engine, engine = engines
    rng = np.random.default_rng(5)
    reqs = []
    for _ in range(48):
        ix = rng.integers(0, len(xy), int(rng.integers(1, 400)))
        reqs.append(xy[ix])
    direct = [engine.assign(r).block.numpy() for r in reqs]
    np.testing.assert_array_equal(
        np.concatenate(direct),
        np.asarray(j_engine.assign(jnp.asarray(np.concatenate(reqs))).block))
    with AsyncGeoServer(engine, ServeConfig(buckets=BUCKETS, cache=True),
                        frontend=FrontendConfig(n_submitters=8,
                                                n_replicas=3)) as srv:
        futures = [None] * len(reqs)
        barrier = threading.Barrier(8)

        def client(cid):
            barrier.wait()
            for i in range(cid, len(reqs), 8):
                futures[i] = srv.submit_async(reqs[i])

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert srv.drain(timeout=60)
        for i, fut in enumerate(futures):
            np.testing.assert_array_equal(
                fut.result(timeout=5).block, direct[i],
                err_msg=f"request {i}")
        snap = srv.snapshot()
        assert snap["counters"]["requests"] == len(reqs)
        assert snap["counters"]["points_served"] \
            == sum(len(r) for r in reqs)


@pytest.mark.timeout(120)
def test_async_concurrent_submitters_bit_identical(engines, points_small):
    """8 client threads submitting racing requests (arrival order
    nondeterministic): per-request results equal the engine's direct
    answer, which equals the JAX package's."""
    _run_concurrent_submitters(engines, points_small[0])


# -- async backpressure ------------------------------------------------------

def _run_shed(engine, xy):
    cfg = ServeConfig(buckets=BUCKETS, cache=False, policy="shed",
                      max_queue_points=64)
    # One submitter serializes puts; a huge flush trigger + deadline
    # parks the flusher so the overflow is deterministic.
    fe = FrontendConfig(n_submitters=1, flush_points=1 << 20,
                        max_delay_ms=10_000.0)
    with AsyncGeoServer(engine, cfg, frontend=fe) as srv:
        f1 = srv.submit_async(xy[:40])
        f2 = srv.submit_async(xy[40:120])          # 40 + 80 > 64: shed
        with pytest.raises(QueueFull):
            f2.result(timeout=5)
        srv.flush()
        assert len(f1.result(timeout=5).block) == 40
        snap = srv.snapshot()
        assert snap["counters"]["shed_requests"] == 1
        assert snap["counters"]["shed_points"] == 80


@pytest.mark.timeout(30)
def test_async_shed_fails_future_with_queue_full(engine, points_small):
    """Under "shed", an overflowing request fails its future with
    QueueFull instead of blocking anyone; serving continues."""
    _run_shed(engine, points_small[0])


@pytest.mark.timeout(30)
def test_async_block_waits_for_room_and_completes(engine, points_small):
    """Under "block", the overflowing submitter sleeps until the flusher
    frees room — both requests complete, nothing is shed."""
    xy, *_ = points_small
    cfg = ServeConfig(buckets=BUCKETS, cache=False, policy="block",
                      max_queue_points=64, max_delay_ms=2.0)
    with AsyncGeoServer(engine, cfg,
                        frontend=FrontendConfig(n_submitters=2)) as srv:
        f1 = srv.submit_async(xy[:60])
        f2 = srv.submit_async(xy[60:160])
        r1, r2 = f1.result(timeout=10), f2.result(timeout=10)
        direct = engine.assign(xy[:160]).block.numpy()
        np.testing.assert_array_equal(
            np.concatenate([r1.block, r2.block]), direct)
        assert srv.snapshot()["counters"].get("shed_requests", 0) == 0


# -- failure recovery / retry budget -----------------------------------------

class _FlakyAssign:
    """Thread-safe assign_padded wrapper failing the first ``n_fail``
    calls (replica threads race through it)."""

    def __init__(self, engine, n_fail):
        self._orig = engine.assign_padded
        self._lock = threading.Lock()
        self.n_fail = n_fail
        self.calls = 0

    def __call__(self, points, n_valid):
        with self._lock:
            self.calls += 1
            fail = self.calls <= self.n_fail
        if fail:
            raise RuntimeError("device lost")
        return self._orig(points, n_valid)


@pytest.mark.timeout(30)
def test_async_requeue_retries_failed_batch(engine, points_small,
                                            monkeypatch):
    xy, *_ = points_small
    cfg = ServeConfig(buckets=BUCKETS, cache=False, max_delay_ms=2.0)
    monkeypatch.setattr(engine, "assign_padded", _FlakyAssign(engine, 1))
    with AsyncGeoServer(engine, cfg) as srv:
        fut = srv.submit_async(xy[:100])
        res = fut.result(timeout=10)               # survives one failure
        snap = srv.snapshot()
    monkeypatch.undo()
    np.testing.assert_array_equal(res.block,
                                  engine.assign(xy[:100]).block.numpy())
    assert snap["counters"]["failed_flushes"] == 1
    assert snap["counters"].get("failed_requests", 0) == 0


@pytest.mark.timeout(30)
def test_async_retry_budget_exhaustion_fails_future(engine, points_small,
                                                    monkeypatch):
    """A permanently failing batch (as a sticky CUDA error would be)
    fails the future with the engine's exception after max_retries — no
    crash-loop, no hang — and the server keeps serving afterwards."""
    xy, *_ = points_small
    cfg = ServeConfig(buckets=BUCKETS, cache=False, max_delay_ms=2.0)
    monkeypatch.setattr(engine, "assign_padded",
                        _FlakyAssign(engine, 10 ** 9))
    with AsyncGeoServer(engine, cfg,
                        frontend=FrontendConfig(max_retries=1)) as srv:
        fut = srv.submit_async(xy[:50])
        with pytest.raises(RuntimeError, match="device lost"):
            fut.result(timeout=10)
        snap = srv.snapshot()
        assert snap["counters"]["failed_requests"] == 1
        assert snap["counters"]["failed_flushes"] == 2
        assert srv.batcher.queued_points == 0
        monkeypatch.undo()
        ok = srv.submit(xy[:10], timeout=10)
        np.testing.assert_array_equal(ok.block,
                                      engine.assign(xy[:10]).block.numpy())


# -- deadline loop / lifecycle -----------------------------------------------

@pytest.mark.timeout(30)
def test_async_deadline_loop_serves_trickle(engine, points_small):
    """A lone small request is served by the background deadline flusher
    with no flush()/drain() call from anyone."""
    xy, *_ = points_small
    cfg = ServeConfig(buckets=BUCKETS, cache=False, max_delay_ms=2.0)
    with AsyncGeoServer(engine, cfg) as srv:
        res = srv.submit_async(xy[:5]).result(timeout=10)
        assert len(res.block) == 5
        assert srv.snapshot()["counters"]["deadline_flushes"] >= 1


@pytest.mark.timeout(30)
def test_async_lifecycle_drain_close_empty(engine):
    cfg = ServeConfig(buckets=BUCKETS, cache=False)
    srv = AsyncGeoServer(engine, cfg)
    assert srv.drain(timeout=1)
    res = srv.submit(np.empty((0, 2), np.float32), timeout=5)
    assert res.block.shape == (0,)
    with pytest.raises(NotImplementedError):
        srv.enqueue(np.zeros((3, 2), np.float32))
    srv.close()
    srv.close()                                    # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit_async(np.zeros((3, 2), np.float32))


@pytest.mark.timeout(60)
def test_async_close_serves_queued_work(engine, points_small):
    """close() drains in-flight work before stopping: every accepted
    future resolves."""
    xy, *_ = points_small
    cfg = ServeConfig(buckets=BUCKETS, cache=False, max_delay_ms=50.0)
    srv = AsyncGeoServer(engine, cfg,
                         frontend=FrontendConfig(n_submitters=4,
                                                 n_replicas=2))
    futures = [srv.submit_async(xy[i * 37:(i + 1) * 37])
               for i in range(20)]
    srv.close()
    for fut in futures:
        assert len(fut.result(timeout=5).block) == 37


# -- runtime lock check over the port (G1) -----------------------------------

@contextlib.contextmanager
def _port_lockcheck():
    """Instrument the port's PORT_TARGETS with the JAX package's runtime
    lock checker; yields the per-class guard tables.  Restores the
    classes on exit (``lockcheck.uninstall``, or only these patches when
    the session's REPRO_LOCKCHECK hook had already patched ``repro``)."""
    n0 = len(lockcheck._installed)
    guards = {}
    for mod_name, cls_name, lock_attrs in PORT_TARGETS:
        module = importlib.import_module(mod_name)
        guards[cls_name] = lockcheck._module_guards(module).get(cls_name,
                                                                 {})
        lockcheck._patch(getattr(module, cls_name), lock_attrs,
                         guards[cls_name])
    try:
        yield guards
    finally:
        if n0 == 0:
            lockcheck.uninstall()
        else:
            while len(lockcheck._installed) > n0:
                cls, attr, original = lockcheck._installed.pop()
                if original is lockcheck._MISSING:
                    delattr(cls, attr)
                else:
                    setattr(cls, attr, original)


@pytest.mark.timeout(120)
def test_lockcheck_over_port_concurrent_and_shed(engines, points_small):
    """The 8-submitter bit-identity case and the shed case under the
    instrumented port classes: no guarded write without its lock, no
    lock acquisition-order cycle.  A deliberate unguarded write shows the
    instrumentation sees the port's fields."""
    registry = lockcheck.registry
    with _port_lockcheck() as guards:
        assert guards["MicroBatcher"] and guards["HotCellCache"] \
            and guards["_Ticket"] and guards["WindowedAggregator"]
        seen = len(registry.violations)
        _run_concurrent_submitters(engines, points_small[0])
        _run_shed(engines[1], points_small[0])
        fresh = registry.violations[seen:]
        cycle = registry.find_cycle()
        names = set(registry.edges) | {
            n for dst in registry.edges.values() for n in dst}
        probe = HotCellCache(CellTable(
            lo=np.zeros(1, np.int32), hi=np.zeros(1, np.int32),
            val=np.zeros(1, np.int32), quant=np.zeros(4, np.float32),
            max_level=8))
        probe.hits = 5                   # no lock held: must be recorded
        planted = registry.violations[seen + len(fresh):]
        del registry.violations[seen + len(fresh):]
    assert not fresh, fresh
    assert cycle is None, cycle
    assert {"MicroBatcher._cond", "AsyncGeoServer._dispatch_lock"} <= names
    assert len(planted) == 1 and "HotCellCache.hits" in planted[0]


# -- sustained load (opt-in: --run-load) -------------------------------------

@pytest.mark.load
@pytest.mark.timeout(120)
def test_sustained_load_soak(engine, points_small):
    """~2s of closed-loop 8-client traffic: every future resolves, ids
    match direct assign, points_in == points_served + shed."""
    xy, *_ = points_small
    cfg = ServeConfig(buckets=BUCKETS, cache=True, policy="shed",
                      max_queue_points=1 << 15, max_delay_ms=2.0)
    with AsyncGeoServer(engine, cfg,
                        frontend=FrontendConfig(n_submitters=8,
                                                n_replicas=3)) as srv:
        srv.warm()
        stop = time.perf_counter() + 2.0
        results, errors = [], []
        lock = threading.Lock()

        def client(cid):
            rng = np.random.default_rng(cid)
            while time.perf_counter() < stop:
                ix = rng.integers(0, len(xy), int(rng.integers(1, 256)))
                try:
                    res = srv.submit(xy[ix], timeout=30)
                    with lock:
                        results.append((ix, np.asarray(res.block)))
                except QueueFull:
                    pass
                except Exception as e:  # pragma: no cover - failure path
                    errors.append(e)
                    return

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not errors, errors
        assert srv.drain(timeout=60)
        assert len(results) > 50
        direct = engine.assign(xy).block.numpy()
        for ix, got in results[::17]:
            np.testing.assert_array_equal(got, direct[ix])
        c = srv.snapshot()["counters"]
        assert c["points_in"] == c["points_served"] \
            + c.get("shed_points", 0)

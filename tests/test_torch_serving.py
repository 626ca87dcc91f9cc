"""The port's serving slice (src/repro_torch/serving: GeoServer, the
micro-batcher, the hot-cell cache, the metrics registry) on the CPU,
mirroring tests/test_serving.py, and held against the JAX package's
server on the same request streams: served state / county / block /
region ids equal the JAX server's and a direct assign on the owning
engine (cache on and off, two regions, a shared border, off-extent
points), and the merged ``GeoStats`` equal.  Tolerance: exact equality
(ids and counters are integers).
"""
import dataclasses
import json
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import EngineConfig as JConfig
from repro.core.engine import GeoEngine as JEngine
from repro.core.resolve import GeoStats as JGeoStats
from repro.core.resolve import ResolveStats as JResolveStats
from repro.core.synth import build_synth_census
from repro.serving import GeoServer as JServer
from repro.serving import ServeConfig as JServeConfig
from repro.serving import MicroBatcher as JMicroBatcher
from repro_torch.core.cells import CellCovering
from repro_torch.core.engine import EngineConfig, GeoEngine
from repro_torch.core.resolve import GeoStats, ResolveStats
from repro_torch.serving import (GeoServer, MicroBatcher, QueueFull,
                                 ServeConfig, bucket_for)

CAPS = dict(cap_state=1.0, cap_county=1.0, cap_block=1.0, cap_boundary=1.0,
            max_level=8)
BUCKETS = (64, 256, 1024)
# Mixed request sizes exercising every bucket, splits, and coalescing.
STREAM = (1, 7, 300, 555, 1024, 113)
CASES = {"simple": ("simple", {}), "fast_fused": ("fast", {"fused": True}),
         "hybrid": ("hybrid", {})}


@pytest.fixture(scope="module")
def engines(synth_small):
    """(JAX engine with backend ref, port engine on the CPU) per case,
    over one covering."""
    census = synth_small.census
    j_fast = JEngine.build(census, "fast",
                           JConfig(backend="ref", fused=True, **CAPS))
    t_cov = CellCovering(**dataclasses.asdict(j_fast.covering))
    out = {}
    for name, (strategy, kw) in CASES.items():
        j = j_fast if name == "fast_fused" else JEngine.build(
            census, strategy, JConfig(backend="ref", **CAPS, **kw),
            covering=j_fast.covering)
        t = GeoEngine.build(census, strategy, EngineConfig(**CAPS, **kw),
                            covering=t_cov, device="cpu")
        out[name] = (j, t)
    return out


def _ids(res):
    return [r.numpy() if isinstance(r, torch.Tensor) else np.asarray(r)
            for r in (res.state, res.county, res.block)]


def _serve_stream(server, xy):
    off, outs = 0, []
    for n in STREAM:
        outs.append(server.submit(xy[off:off + n]))
        off += n
    return off, outs


# -- batcher -----------------------------------------------------------------

def test_bucket_for_ladder():
    assert [bucket_for(n, BUCKETS) for n in (1, 64, 65, 1024, 5000)] == \
        [64, 64, 256, 1024, 1024]


def test_batcher_coalesces_fifo_and_splits():
    """Same batches and parts as the JAX package's batcher."""
    got = []
    for cls in (MicroBatcher, JMicroBatcher):
        b = cls(buckets=BUCKETS, max_queue_points=1 << 16)
        for i, n in enumerate((10, 50, 1100, 30)):
            assert b.put(f"t{i}", np.full((n, 2), float(i), np.float32))
        batches = b.drain()
        assert b.queued_points == 0 and len(b) == 0
        got.append([(len(mb.points), mb.parts) for mb in batches])
    assert got[0] == got[1]
    assert [n for n, _ in got[0]] == [1024, 166]


def test_batcher_validation_and_age():
    with pytest.raises(ValueError, match="buckets"):
        MicroBatcher(buckets=(256, 64))
    with pytest.raises(ValueError, match="policy"):
        MicroBatcher(policy="drop")
    b = MicroBatcher(buckets=BUCKETS)
    assert b.oldest_age_s() == 0.0
    b.put("t0", np.zeros((4, 2), np.float32))
    time.sleep(0.002)
    assert b.oldest_age_s() > 0.0
    b.drain()
    assert b.oldest_age_s() == 0.0


# -- stats merges ------------------------------------------------------------

def test_resolve_stats_merge_counters():
    a = ResolveStats(n_need=1, n_pip=2, overflow=3, phase2_miss=4)
    b = ResolveStats(n_need=10, n_pip=20, overflow=30, phase2_miss=40)
    want = {"n_need": 11, "n_pip": 22, "overflow": 33, "phase2_miss": 44}
    assert a.merge(b).as_dict() == want
    assert JResolveStats(1, 2, 3, 4).merge(
        JResolveStats(10, 20, 30, 40)).as_dict() == want


def test_geo_stats_merge_sums_nested_extra():
    """Counters and every leaf of the nested ``extra`` dict sum, as in
    the JAX package; the inputs are not mutated."""
    def mk(cls, k, like):
        return cls(n_need=like(1 * k), n_pip=like(2 * k),
                   overflow=like(0),
                   extra={"n_boundary": like(3 * k),
                          "state": {"phase2_miss": like(k),
                                    "n_pip": like(5 * k)}})
    a = mk(GeoStats, 1, torch.tensor)
    merged = a.merge(mk(GeoStats, 10, torch.tensor))
    j_merged = mk(JGeoStats, 1, jnp.asarray).merge(
        mk(JGeoStats, 10, jnp.asarray))
    assert merged.as_dict() == j_merged.as_dict()
    assert int(merged.extra["state"]["n_pip"]) == 55
    assert int(a.extra["state"]["n_pip"]) == 5
    with pytest.raises(ValueError, match="keys"):
        a.merge(GeoStats(1, 2, 0, extra={"other": torch.tensor(1)}))


# -- serving bit-identity ----------------------------------------------------

@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("cache", [False, True])
def test_server_matches_reference_and_direct_assign(engines, points_small,
                                                    name, cache):
    """Mixed-size request streams: the port server's ids equal the JAX
    server's and a direct assign, cache on and off; a second pass (cache
    warm) stays identical; the merged GeoStats equal the JAX server's."""
    j_eng, t_eng = engines[name]
    xy = points_small[0]
    direct = _ids(t_eng.assign(xy))
    servers = (GeoServer(t_eng, ServeConfig(buckets=BUCKETS, cache=cache)),
               JServer(j_eng, JServeConfig(buckets=BUCKETS, cache=cache)))
    outs = []
    for server in servers:
        server.warm()
        off, res = _serve_stream(server, xy)
        outs.append(res)
    for t_res, j_res in zip(*outs):
        for field in ("state", "county", "block", "region"):
            np.testing.assert_array_equal(getattr(t_res, field),
                                          getattr(j_res, field))
    for got, want in zip(("state", "county", "block"), direct):
        np.testing.assert_array_equal(
            np.concatenate([getattr(r, got) for r in outs[0]]), want[:off])
    assert servers[0].stats[0].as_dict() == servers[1].stats[0].as_dict()
    if cache:
        assert servers[0].cache_snapshot() == servers[1].cache_snapshot()
    again = servers[0].submit(xy[:off])
    np.testing.assert_array_equal(again.block, direct[2][:off])
    if cache:
        assert servers[0].cache_snapshot()["hits"] > 0


def test_server_preserves_partial_assignments(engines, synth_small):
    """The cascade can resolve a point's state yet lose its block; the
    server returns that partial answer as the engine gives it."""
    x0, x1, y0, y1 = synth_small.census.extent
    rng = np.random.default_rng(9)
    pts = np.stack([rng.uniform(x0, x1, 3000),
                    rng.uniform(y0, y1, 3000)], -1).astype(np.float32)
    _, eng = engines["simple"]
    direct = _ids(eng.assign(pts))
    assert ((direct[0] >= 0) & (direct[2] < 0)).any()
    for cache in (False, True):
        res = GeoServer(eng, ServeConfig(buckets=BUCKETS,
                                         cache=cache)).submit(pts)
        for field, want in zip(("state", "county", "block"), direct):
            np.testing.assert_array_equal(getattr(res, field), want)


def test_flush_requeues_unserved_work_on_engine_error(engines,
                                                      points_small,
                                                      monkeypatch):
    xy = points_small[0]
    _, eng = engines["fast_fused"]
    server = GeoServer(eng, ServeConfig(buckets=BUCKETS, cache=False))
    ticket = server.enqueue(xy[:100])

    def fail(points, n_valid):
        raise RuntimeError("device lost")
    monkeypatch.setattr(eng, "assign_padded", fail)
    with pytest.raises(RuntimeError, match="device lost"):
        server.flush()
    assert not ticket.done and server.batcher.queued_points == 100
    assert server.snapshot()["counters"]["failed_flushes"] == 1
    monkeypatch.undo()
    server.flush()
    np.testing.assert_array_equal(ticket.result().block,
                                  eng.assign(xy[:100]).block.numpy())


def test_server_stats_merge_across_microbatches(engines, points_small):
    _, eng = engines["fast_fused"]
    server = GeoServer(eng, ServeConfig(buckets=BUCKETS, cache=False))
    off, _ = _serve_stream(server, points_small[0])
    merged = server.stats[0].as_dict()
    direct = eng.assign(points_small[0][:off]).stats.as_dict()
    for key in ("n_boundary", "overflow", "phase2_miss"):
        assert merged[key] == direct[key], key


# -- deadline flush ----------------------------------------------------------

def test_deadline_flush_on_enqueue_and_poll(engines, points_small):
    xy = points_small[0]
    _, eng = engines["fast_fused"]
    server = GeoServer(eng, ServeConfig(buckets=BUCKETS, cache=False,
                                        max_delay_ms=0.0))
    ticket = server.enqueue(xy[:37])
    assert ticket.done
    assert server.snapshot()["counters"]["deadline_flushes"] >= 1
    np.testing.assert_array_equal(ticket.result().block,
                                  eng.assign(xy[:37]).block.numpy())
    slow = GeoServer(eng, ServeConfig(buckets=BUCKETS, cache=False,
                                      max_delay_ms=200.0))
    ticket = slow.enqueue(xy[:3])
    assert not ticket.done and slow.poll() == 0
    time.sleep(0.25)
    assert slow.poll() == 1 and ticket.done
    plain = GeoServer(eng, ServeConfig(buckets=BUCKETS, cache=False))
    ticket = plain.enqueue(xy[:5])
    assert not ticket.done and plain.poll() == 0
    plain.flush()
    assert ticket.done


# -- hot-cell cache ----------------------------------------------------------

def test_cache_learns_only_interior_cells_and_evicts(engines, points_small):
    xy = points_small[0]
    _, eng = engines["fast_fused"]
    server = GeoServer(eng, ServeConfig(buckets=BUCKETS, cache=True))
    server.submit(xy[:1000])
    cache = server.regions[0].cache
    codes = np.fromiter(cache._map.keys(), np.int64)
    vals = np.fromiter(cache._map.values(), np.int64)
    assert len(codes) > 0 and np.all(vals >= 0)
    np.testing.assert_array_equal(
        cache.table.interior_value(codes.astype(np.int32)), vals)
    small = GeoServer(eng, ServeConfig(buckets=BUCKETS, cache=True,
                                       cache_capacity=8))
    small.submit(xy[:1000])
    cache = small.regions[0].cache
    assert len(cache) <= 8 and cache.evictions > 0
    assert small.snapshot()["gauges"]["cache_evictions"] == cache.evictions


def test_off_extent_points_not_cached_and_serve_minus_one(engines,
                                                          synth_small):
    x0, x1, y0, y1 = synth_small.census.extent
    w, h = x1 - x0, y1 - y0
    far = np.array([[x1 + w, (y0 + y1) / 2], [x0 - 2 * w, y0 - h]],
                   np.float32)
    _, eng = engines["fast_fused"]
    server = GeoServer(eng, ServeConfig(buckets=BUCKETS, cache=True))
    for _ in range(2):
        res = server.submit(far)
        for field in ("block", "state", "region"):
            np.testing.assert_array_equal(getattr(res, field), -1)
    assert len(server.regions[0].cache) == 0
    assert server.cache_snapshot()["hits"] == 0


# -- backpressure ------------------------------------------------------------

def test_backpressure_shed_and_block(engines, points_small):
    xy = points_small[0]
    _, eng = engines["fast_fused"]
    shed = GeoServer(eng, ServeConfig(buckets=BUCKETS, max_queue_points=100,
                                      policy="shed", cache=False))
    shed.enqueue(xy[:80])
    with pytest.raises(QueueFull):
        shed.enqueue(xy[80:160])
    assert shed.snapshot()["counters"]["shed_requests"] == 1
    shed.flush()
    assert len(shed.submit(xy[:10]).block) == 10
    block = GeoServer(eng, ServeConfig(buckets=BUCKETS,
                                       max_queue_points=100,
                                       policy="block", cache=False))
    t1 = block.enqueue(xy[:80])
    t2 = block.enqueue(xy[80:160])           # overflow -> inline flush
    assert t1.done
    block.flush()
    np.testing.assert_array_equal(
        np.concatenate([t1.result().block, t2.result().block]),
        eng.assign(xy[:160]).block.numpy())


# -- metrics -----------------------------------------------------------------

def test_metrics_snapshot_schema_and_json(engines, points_small):
    _, eng = engines["hybrid"]
    server = GeoServer(eng, ServeConfig(buckets=BUCKETS, cache=True))
    server.warm()
    _serve_stream(server, points_small[0])
    assert server.metrics.snapshot()["gauges"]["cache_misses"] > 0
    snap = server.snapshot()
    c, d = snap["counters"], snap["derived"]
    assert c["requests"] == len(STREAM)
    assert c["points_in"] == c["points_served"] == sum(STREAM)
    for key in ("geo_phase2_miss", "geo_overflow", "geo_n_boundary",
                "geo_n_pip", "cache_hits_total", "cache_misses_total",
                "batches", "padded_slots", "valid_slots", "warm_batches"):
        assert key in c, key
    assert c["cache_hits_total"] >= snap["gauges"]["cache_hits"] > 0
    assert 0 < d["batch_fill_ratio"] <= 1
    lat = snap["latency_ms"]
    assert lat["count_total"] == lat["count_window"] == len(STREAM)
    assert 0 <= lat["p50"] <= lat["p99"] <= lat["max"]
    for stage in ("queue_wait", "host_prepare", "device_assign", "merge",
                  "request"):
        assert snap["stages"][stage]["count"] > 0, stage
    json.loads(server.metrics.to_json())
    # The index footprint of the built engine is surfaced as gauges.
    assert any(k.startswith("region0_") for k in snap["gauges"])


def test_warm_and_empty_requests(engines):
    _, eng = engines["fast_fused"]
    server = GeoServer(eng, ServeConfig(buckets=BUCKETS, cache=False))
    times = server.warm()
    assert set(times) == set(BUCKETS) and all(t >= 0
                                              for t in times.values())
    assert server.flush() == 0
    res = server.submit(np.empty((0, 2), np.float32))
    assert res.block.shape == (0,) and res.latency_s == 0.0
    assert server.flush() == 0


def test_build_and_from_artifact(synth_small, points_small, tmp_path):
    """``GeoServer.build`` on the CPU, then a cold start from the artifact
    its engine saves: the same plan, ids and stats, the covering read
    from disk (the cache needs it), the index on the asked device."""
    server = GeoServer.build(synth_small.census, "fast",
                             ServeConfig(buckets=BUCKETS, cache=False),
                             EngineConfig(max_level=7), device="cpu")
    engine = server.regions[0].engine
    assert engine.device.type == "cpu"
    engine.indices.save(str(tmp_path))
    cold = GeoServer.from_artifact(str(tmp_path), strategy="fast",
                                   cfg=ServeConfig(buckets=BUCKETS),
                                   engine_cfg=engine.cfg, device="cpu")
    cold_engine = cold.regions[0].engine
    assert cold_engine.device.type == "cpu"
    assert cold_engine.explain() == engine.explain()
    assert cold.regions[0].cache is not None
    xy = points_small[0][:700]
    a, b = server.submit(xy), cold.submit(xy)
    for field in ("state", "county", "block", "region"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    assert cold.stats[0].as_dict() == server.stats[0].as_dict()


# -- multi-region routing ----------------------------------------------------

@pytest.fixture(scope="module")
def two_regions():
    """Two regional censuses with extents sharing the x = -100 border, a
    port engine and a JAX engine for each."""
    out = []
    for seed, extent in ((3, (-120.0, -100.0, 30.0, 45.0)),
                         (4, (-100.0, -80.0, 30.0, 45.0))):
        sc = build_synth_census(seed=seed, n_states=2, counties_per_state=2,
                                blocks_per_county=4, extent=extent)
        out.append((sc, GeoEngine.build(
            sc.census, "fast", EngineConfig(cap_boundary=1.0, max_level=8),
            device="cpu"), JEngine.build(
            sc.census, "fast",
            JConfig(backend="ref", cap_boundary=1.0, max_level=8))))
    return out


@pytest.mark.parametrize("kind", ["interleaved", "border", "nowhere",
                                  "overlap"])
def test_router_matches_reference(two_regions, kind):
    """Multi-region routing: ids and owning regions equal the JAX
    server's and each owner's direct assign; border points get one
    deterministic owner; points in no extent are -1 everywhere."""
    (scA, tA, jA), (scB, tB, jB) = two_regions
    if kind == "interleaved":
        xyA, *_ = scA.sample_points(np.random.default_rng(1), 100)
        xyB, *_ = scB.sample_points(np.random.default_rng(2), 100)
        pts = np.empty((200, 2), np.float32)
        pts[0::2], pts[1::2] = xyA, xyB
    elif kind == "border":
        pts = np.array([[-100.0, 37.5], [-100.0, 33.0]], np.float32)
    elif kind == "nowhere":
        pts = np.array([[-150.0, 37.0], [0.0, 0.0], [-90.0, 70.0]],
                       np.float32)
    else:
        pts, *_ = scA.sample_points(np.random.default_rng(5), 50)
    t_engs, j_engs = ([tA, tA], [jA, jA]) if kind == "overlap" \
        else ([tA, tB], [jA, jB])
    t_srv = GeoServer(t_engs, ServeConfig(buckets=BUCKETS, cache=False))
    j_srv = JServer(j_engs, JServeConfig(buckets=BUCKETS, cache=False))
    first = t_srv.submit(pts)
    want = j_srv.submit(pts)
    for field in ("state", "county", "block", "region"):
        np.testing.assert_array_equal(getattr(first, field),
                                      getattr(want, field))
    again = t_srv.submit(pts)
    np.testing.assert_array_equal(again.region, first.region)
    np.testing.assert_array_equal(again.block, first.block)
    if kind == "nowhere":
        assert (first.region == -1).all() and (first.block == -1).all()
    else:
        assert (first.region >= 0).all()
    if kind == "overlap":
        assert (first.region == 0).all()
    for r, eng in enumerate(t_engs):
        sel = first.region == r
        if sel.any():
            np.testing.assert_array_equal(
                first.block[sel], eng.assign(pts[sel]).block.numpy())
    assert t_srv.flush() == 0
    assert t_srv.submit(np.empty((0, 2), np.float32)).block.shape == (0,)

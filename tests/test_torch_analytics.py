"""The port's analytics slice (src/repro_torch/analytics, the segment
twin and ``ops.segment_reduce`` / ``assign_aggregate``) against the JAX
package's, on the same numpy inputs:

* the segment twin against ``repro.kernels.ops.segment_reduce`` run on
  the Pallas kernel under ``backend="interpret"``, against
  ``backend="ref"`` and against the numpy oracle ``np_segment_reduce``:
  count / min / max bit-equal everywhere; sums bit-equal on
  integer-valued columns (any f32 order is exact below 2**24) and, for
  general f32, within rtol 1e-5 of the f64 oracle (the twin's sequential
  f32 sum of up to 1,200 terms in [0, 1) rounds inside that; the card's
  tree sums came within 1.44e-7);
* ``BlockAggregator`` (fused counts, reduce, density, weighted index)
  and ``ops.assign_aggregate`` on an index carried across from
  ``repro``: exact equality (integer counts; density and the composite
  are the same float64 numpy code on equal inputs);
* ``splitmix64``, ``DistinctSketch`` bitmaps and ``WindowedAggregator``
  snapshots: exact equality on the same feeds;
* the windowed analytics mounted on the port's ``GeoServer`` (cases of
  tests/test_analytics.py), and its analytics snapshot equal to the JAX
  server's on the same requests, clock and request-sequence start.

The CUDA kernel runs only on a card: the ``cuda`` cases skip here;
chip_smoke.py holds it against its twin on the main path's inputs.
"""
import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analytics import AnalyticsConfig as JAnalyticsConfig
from repro.analytics import BlockAggregator as JBlockAggregator
from repro.analytics import DistinctSketch as JDistinctSketch
from repro.analytics import WindowedAggregator as JWindowedAggregator
from repro.analytics import splitmix64 as j_splitmix64
from repro.core.cells import build_cell_covering
from repro.core.engine import EngineConfig as JConfig
from repro.core.engine import GeoEngine as JEngine
from repro.core.fast import FastIndex as JFastIndex
from repro.kernels import ops as j_ops
from repro.kernels.ref import np_segment_reduce as j_np_segment_reduce
from repro.serving import GeoServer as JServer
from repro.serving import ServeConfig as JServeConfig
from repro.serving import server as j_server_mod
from repro_torch.analytics import (AnalyticsConfig, BlockAggregator,
                                   DistinctSketch, WindowedAggregator,
                                   WindowState, splitmix64)
from repro_torch.core.cells import CellCovering
from repro_torch.core.engine import EngineConfig, GeoEngine
from repro_torch.core.fast import INDEX_FIELDS, FastIndex
from repro_torch.core.geometry import polygon_areas
from repro_torch.kernels import ops, ref, segment
from repro_torch.serving import GeoServer, ServeConfig
from repro_torch.serving import server as t_server_mod

NEEDS_CUDA = "needs a CUDA device; chip_smoke.py checks it"
SUM_RTOL = 1e-5          # general f32 sums vs the f64 oracle

# (n rows, n segments, id kind, value kind)
SEGMENT_CASES = {
    "mixed_int": (3000, 257, "mixed", "int"),
    "mixed_float": (2500, 130, "mixed", "float"),
    "skewed_int": (3000, 200, "skewed", "int"),
    "skewed_float": (3000, 200, "skewed", "float"),
    "odd_segments_int": (1111, 777, "mixed", "int"),
    "all_invalid": (64, 8, "invalid", "int"),
    "empty_input": (0, 16, "mixed", "int"),
}


def _segment_inputs(case):
    n, s, ids_kind, val_kind = SEGMENT_CASES[case]
    rng = np.random.default_rng(sorted(SEGMENT_CASES).index(case))
    ids = rng.integers(-2, s + 2, size=n)           # out of range both ways
    if ids_kind == "skewed":                        # 40 % in one segment
        ids[rng.random(n) < 0.4] = s // 3
    elif ids_kind == "invalid":
        ids = np.where(rng.random(n) < 0.5, -1, s + 5)
    vals = (rng.integers(-50, 50, size=n) if val_kind == "int"
            else rng.random(n)).astype(np.float32)
    return ids.astype(np.int32), vals, s, val_kind


def _np(t):
    return np.asarray(t) if not isinstance(t, torch.Tensor) \
        else t.cpu().numpy()


def _assert_matches(got, want, val_kind):
    """count / min / max bit-equal; sum bit-equal on integer-valued
    columns, else within SUM_RTOL."""
    names = ("count", "sum", "min", "max")
    for name, a, b in zip(names, got, want):
        a, b = _np(a), _np(b)
        if name == "sum" and val_kind != "int":
            np.testing.assert_allclose(a, b, rtol=SUM_RTOL, atol=1e-6)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


# ------------------------------------------------------- segment reduce
@pytest.mark.parametrize("case", list(SEGMENT_CASES))
def test_segment_twin_matches_reference(case):
    """The port's op (its twin on the CPU) against the numpy oracle, the
    JAX ``ref`` backend and the Pallas kernel under interpret."""
    ids, vals, s, kind = _segment_inputs(case)
    got = ops.segment_reduce(torch.from_numpy(ids), torch.from_numpy(vals),
                             n_segments=s)
    _assert_matches(got, j_np_segment_reduce(ids, vals, s), kind)
    _assert_matches(got, ref.np_segment_reduce(ids, vals, s), kind)
    jref = j_ops.segment_reduce(jnp.asarray(ids), jnp.asarray(vals),
                                n_segments=s, backend="ref")
    _assert_matches(got, jref, kind)
    if len(ids):                    # the Pallas grid needs a row tile
        jint = j_ops.segment_reduce(jnp.asarray(ids), jnp.asarray(vals),
                                    n_segments=s, backend="interpret",
                                    bp=128, bs=128)
        _assert_matches(got, jint, kind)
    assert got.count.dtype == torch.int32
    assert got.sum.dtype == got.min.dtype == torch.float32


def test_segment_empty_segments_and_invalid_rows():
    """All-invalid ids give zero counts and the empty-segment sentinels
    (sum 0, min +inf, max -inf); ``values=None`` is a zero column."""
    ids = torch.tensor([-1, -5, 99, 100], dtype=torch.int32)
    out = ops.segment_reduce(ids, None, n_segments=8)
    assert int(out.count.sum()) == 0
    assert (out.sum == 0.0).all()
    assert torch.isposinf(out.min).all() and torch.isneginf(out.max).all()
    counts = ops.segment_counts(torch.tensor([0, 0, 3, -1, 8, 3],
                                             dtype=torch.int32),
                                n_segments=8)
    np.testing.assert_array_equal(counts.numpy(),
                                  [2, 0, 0, 2, 0, 0, 0, 0])
    j = j_ops.segment_counts(jnp.asarray([0, 0, 3, -1, 8, 3], jnp.int32),
                             n_segments=8, backend="ref")
    np.testing.assert_array_equal(counts.numpy(), np.asarray(j))
    with pytest.raises(ValueError, match="do not match"):
        ops.segment_reduce(ids, torch.zeros(3), n_segments=8)


def test_segment_wrapper_takes_the_twin_on_cpu():
    """The wrapper's CPU branch is the twin, on sorted parked input."""
    ids, vals, s, _ = _segment_inputs("mixed_int")
    park = np.where((ids < 0) | (ids >= s), s, ids)
    order = np.argsort(park, kind="stable")
    got = segment.segment_reduce_sorted(torch.from_numpy(park[order]),
                                        torch.from_numpy(vals[order]), s)
    _assert_matches(got, j_np_segment_reduce(ids, vals, s), "int")


def _wrapper_inputs(kind):
    """Sorted ids and values straight to ``segment_reduce_sorted``:
    ``parked`` as ``ops`` parks them, ``unparked`` with -1 and >= S ids
    left in place (they land nowhere), ``no_values`` a zero column given
    as None."""
    ids, vals, s, _ = _segment_inputs("skewed_int")
    ids[:5] = -1                    # negative ids at the front once sorted
    if kind == "parked":
        ids = np.where((ids < 0) | (ids >= s), s, ids)
    order = np.argsort(ids, kind="stable")
    return ids[order], None if kind == "no_values" else vals[order], s


@pytest.mark.parametrize("kind", ["parked", "unparked", "no_values"])
def test_segment_wrapper_contract_on_cpu(kind):
    """Out-of-range ids and a missing value column, straight to the
    wrapper (its twin on the CPU), give the oracle's answer."""
    ids, vals, s = _wrapper_inputs(kind)
    got = segment.segment_reduce_sorted(
        torch.from_numpy(ids), None if vals is None else torch.from_numpy(
            vals), s)
    _assert_matches(got, ref.np_segment_reduce(ids, vals, s), "int")
    assert int(got[0].sum()) == int(((ids >= 0) & (ids < s)).sum())


# -------------------------------------------- aggregation on an index
@pytest.fixture(scope="module")
def covering(synth_small):
    return build_cell_covering(synth_small.census, max_level=8)


@pytest.fixture(scope="module")
def fast_engines(synth_small, covering):
    """The JAX ``fast`` engine (backend ref) and the port's on the CPU,
    over one covering."""
    census = synth_small.census
    t_cov = CellCovering(**dataclasses.asdict(covering))
    return (JEngine.build(census, "fast",
                          JConfig(backend="ref", max_level=8),
                          covering=covering),
            GeoEngine.build(census, "fast", EngineConfig(max_level=8),
                            covering=t_cov, device="cpu"))


def test_block_aggregator_matches_reference(fast_engines, points_small):
    """fused counts, unfused counts, reduce with an integer-valued
    column, density and the weighted composite equal the JAX
    aggregator's."""
    j_eng, t_eng = fast_engines
    pts = points_small[0][:2048]
    j_agg = JBlockAggregator.from_engine(j_eng)
    t_agg = BlockAggregator.from_engine(t_eng)
    assert t_agg.n_blocks == j_agg.n_blocks
    np.testing.assert_array_equal(t_agg.areas, j_agg.areas)
    fused = t_agg.fused_counts(pts)
    np.testing.assert_array_equal(
        fused, np.asarray(j_agg.fused_counts(jnp.asarray(pts))))
    bid = t_eng.assign(pts).block
    np.testing.assert_array_equal(fused, t_agg.counts(bid))
    assert fused.sum() == int((bid >= 0).sum())
    parked = t_agg.fused_ids(pts)
    assert parked.dtype == torch.int32
    assert int(parked.min()) >= 0 and int(parked.max()) <= t_agg.n_blocks
    vals = np.random.default_rng(7).integers(0, 100, len(pts)).astype(
        np.float32)
    got = t_agg.reduce(bid, vals)
    want = j_agg.reduce(jnp.asarray(bid.numpy()), jnp.asarray(vals))
    _assert_matches(got, want, "int")
    dens = t_agg.density(fused)
    np.testing.assert_array_equal(dens, j_agg.density(fused))
    cols = np.stack([dens, fused.astype(np.float64)], axis=1)
    np.testing.assert_array_equal(t_agg.weighted_index(cols, [0.6, 0.4]),
                                  j_agg.weighted_index(cols, [0.6, 0.4]))


def test_block_aggregator_validation_and_reduce_counts(fast_engines):
    j_eng, t_eng = fast_engines
    agg = BlockAggregator(5, device="cpu")
    with pytest.raises(ValueError, match="engine"):
        agg.fused_ids(np.zeros((1, 2), np.float32))
    with pytest.raises(ValueError, match="areas"):
        agg.density(np.zeros(5))
    with pytest.raises(ValueError, match="blocks"):
        BlockAggregator(5, np.ones(4), device="cpu")
    parked = torch.tensor([0, 5, 2, 2, 5, 4], dtype=torch.int32)
    np.testing.assert_array_equal(agg.reduce_counts(parked),
                                  [1, 0, 2, 0, 1])
    # An explicit backend reduces through ops.segment_counts.
    np.testing.assert_array_equal(
        BlockAggregator(5, backend="ref",
                        device="cpu").reduce_counts(parked),
        [1, 0, 2, 0, 1])
    # Arrays go to the aggregator's device.
    out = agg.reduce(np.array([0, 1, 1, -1]), np.array([1.0, 2.0, 3.0,
                                                       9.0]))
    np.testing.assert_array_equal(out.count.numpy(), [1, 2, 0, 0, 0])
    np.testing.assert_array_equal(out.sum.numpy(), [1.0, 5.0, 0, 0, 0])


@pytest.fixture(scope="module")
def onepass_indices(synth_small, covering):
    j = JFastIndex.from_covering(covering, synth_small.census, gbits=4,
                                 with_pool=True)
    arrays = {f: np.asarray(getattr(j, f)) for f in INDEX_FIELDS}
    arrays.update({f"edge_pool_{f}": np.asarray(getattr(j.edge_pool, f))
                   for f in ("blocks", "first", "count")})
    t = FastIndex.from_numpy(arrays, max_level=j.max_level, gbits=j.gbits,
                             search_iters=j.search_iters, device="cpu")
    return j, t


@pytest.mark.parametrize("with_values", [False, True])
def test_assign_aggregate_matches_reference(onepass_indices, points_small,
                                            with_values):
    """The fused one-pass cascade + segment reduction equals the JAX
    package's (ref backend), aggregates and raw cascade outputs alike,
    and equals segment_reduce of the cascade's own ids."""
    j, t = onepass_indices
    pts = points_small[0][:1500]
    n_seg = int(t.block_parent.shape[0])
    vals = np.random.default_rng(3).integers(-9, 9, len(pts)).astype(
        np.float32) if with_values else None
    fields = ("quant", "cell_lo", "cell_hi", "cell_val", "top_start",
              "cand", "block_bbox")
    kw = dict(n_segments=n_seg, max_level=j.max_level, gbits=j.gbits,
              search_iters=j.search_iters)
    j_red, j_raw = j_ops.assign_aggregate(
        jnp.asarray(pts), *[getattr(j, f) for f in fields], j.edge_pool,
        values=None if vals is None else jnp.asarray(vals),
        backend="ref", **kw)
    t_red, t_raw = ops.assign_aggregate(
        torch.from_numpy(pts), *[getattr(t, f) for f in fields],
        t.edge_pool, values=None if vals is None else torch.from_numpy(vals),
        **kw)
    _assert_matches(t_red, j_red, "int")
    for a, b in zip(t_raw, j_raw):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    again = ops.segment_reduce(t_raw[0], None if vals is None
                               else torch.from_numpy(vals),
                               n_segments=n_seg)
    _assert_matches(t_red, again, "int")
    assert int(t_red.count.sum()) == int((t_raw[0] >= 0).sum())


# ------------------------------------------- sketches and windows
def test_splitmix64_and_sketch_bitmaps_match_reference():
    rng = np.random.default_rng(4)
    x = rng.integers(0, 2**63, 5000, dtype=np.uint64)
    np.testing.assert_array_equal(splitmix64(x), j_splitmix64(x))
    seg = rng.integers(-2, 34, 4000)
    src = rng.integers(0, 700, 4000)
    t_sk, j_sk = DistinctSketch(32, 512), JDistinctSketch(32, 512)
    t_sk.observe(seg, src)
    j_sk.observe(seg, src)
    np.testing.assert_array_equal(t_sk.bitmap, j_sk.bitmap)
    np.testing.assert_array_equal(t_sk.estimate(), j_sk.estimate())
    other = DistinctSketch(32, 512)
    other.observe(seg[::3], src[::3] + 10_000)
    merged = t_sk.merge(other)
    np.testing.assert_array_equal(merged.bitmap,
                                  t_sk.bitmap | other.bitmap)
    with pytest.raises(ValueError, match="multiple of 8"):
        DistinctSketch(4, 12)


def _window_feed(rng, n_batches=40):
    """Timestamped batches with out-of-order and late events."""
    feed = []
    for i in range(n_batches):
        ts = i * 0.7 + rng.uniform(-3.0, 1.0)
        n = int(rng.integers(0, 50))
        feed.append((ts, rng.integers(-1, 21, n), rng.integers(0, 60, n)))
    return feed


@pytest.mark.parametrize("cfg", [
    dict(window_s=5.0, sketch_bits=256),
    dict(window_s=6.0, slide_s=2.0, k_anon=3, sketch_bits=512,
         allowed_lateness_s=1.0),
    dict(window_s=4.0, slide_s=1.0, k_anon=2, sketch_bits=128,
         allowed_lateness_s=0.0, max_finalized=3, top_k=4),
])
def test_windowed_aggregator_matches_reference(cfg):
    """The same out-of-order feed gives equal snapshots, finalized
    windows and counters in both packages."""
    rng = np.random.default_rng(9)
    feed = _window_feed(rng)
    areas = rng.uniform(0.5, 2.0, 20)
    t_agg = WindowedAggregator(20, AnalyticsConfig(**cfg), areas)
    j_agg = JWindowedAggregator(20, JAnalyticsConfig(**cfg), areas)
    for ts, bids, src in feed:
        assert t_agg.observe(ts, bids, src) == j_agg.observe(ts, bids, src)
        assert t_agg.snapshot() == j_agg.snapshot()
    assert t_agg.advance(100.0) == j_agg.advance(100.0)
    assert t_agg.snapshot() == j_agg.snapshot()
    assert len(t_agg.finalized) == len(j_agg.finalized)
    for a, b in zip(t_agg.finalized, j_agg.finalized):
        for field in ("counts", "distinct", "pairs", "suppressed",
                      "density"):
            np.testing.assert_array_equal(getattr(a, field),
                                          getattr(b, field))


def test_window_rotation_out_of_order():
    cfg = AnalyticsConfig(window_s=10.0, allowed_lateness_s=5.0,
                          sketch_bits=256)
    agg = WindowedAggregator(4, cfg)
    agg.observe(1.0, [0], [1])
    agg.observe(12.0, [1], [2])
    agg.observe(3.0, [0], [3])
    assert agg.finalized_total == 0
    agg.observe(16.0, [2], [4])
    assert agg.finalized_total == 1
    assert agg.finalized[0].counts.tolist() == [2, 0, 0, 0]
    assert 0 not in agg.panes
    assert agg.observe(4.0, [3], [5]) == 0 and agg.late_dropped == 1
    assert agg.observed == 5


def test_window_state_merge_associative():
    rng = np.random.default_rng(3)
    states = []
    for _ in range(3):
        st = WindowState(16, 256)
        st.observe(rng.integers(0, 16, 40), rng.integers(0, 1000, 40))
        states.append(st)
    a, b, c = states
    left, right = a.merge(b).merge(c), a.merge(b.merge(c))
    np.testing.assert_array_equal(left.counts, right.counts)
    np.testing.assert_array_equal(left.sketch.bitmap, right.sketch.bitmap)
    assert left.n_events == right.n_events == sum(s.n_events
                                                  for s in states)


def test_k_anonymity_suppression():
    cfg = AnalyticsConfig(window_s=10.0, allowed_lateness_s=0.0, k_anon=3,
                          sketch_bits=512)
    agg = WindowedAggregator(3, cfg)
    agg.observe(1.0, [0] * 5 + [1] * 20, [10, 11, 12, 13, 14] + [99] * 20)
    agg.observe(12.0, [2], [1])
    snap = agg.finalized[0]
    assert snap.suppressed.tolist() == [False, True, False]
    assert snap.counts[1] == 20
    assert [row["block"] for row in snap.top_k(10)] == [0]
    assert snap.pairs[0] == 10
    with pytest.raises(ValueError, match="multiple"):
        AnalyticsConfig(window_s=10.0, slide_s=3.0).resolve()


# ------------------------------------------------- serving integration
def _clock(t):
    return lambda: t[0]


def _serve_both(fast_engines, stream, cache, buckets=(64, 256, 1024),
                **acfg):
    """Feed one request stream (ts, points) through the JAX and the port
    servers with the same clock and request-sequence start."""
    j_eng, t_eng = fast_engines
    tick = [0.0]
    servers = []
    for srv_cls, cfg_cls, ana_cls, eng in (
            (JServer, JServeConfig, JAnalyticsConfig, j_eng),
            (GeoServer, ServeConfig, AnalyticsConfig, t_eng)):
        servers.append(srv_cls(eng, cfg_cls(
            buckets=buckets, cache=cache,
            analytics=ana_cls(clock=_clock(tick), **acfg))))
    results = ([], [])
    for ts, pts in stream:
        tick[0] = ts
        for out, srv in zip(results, servers):
            out.append(srv.submit(pts))
    return servers, results


@pytest.fixture
def fresh_seq(monkeypatch):
    """Both packages' request sequences (the analytics source ids) start
    at 0, so their distinct-source sketches see the same ids."""
    monkeypatch.setattr(j_server_mod._Ticket, "_seq", itertools.count())
    monkeypatch.setattr(t_server_mod._Ticket, "_seq", itertools.count())


@pytest.mark.parametrize("cache", [True, False])
def test_server_analytics_snapshot_matches_reference(fast_engines,
                                                     synth_small, cache,
                                                     fresh_seq):
    """The example's traffic shape (background + a venue hotspot from
    t = 4, a trailing batch that closes the windows): the port server's
    ids and analytics snapshot equal the JAX server's."""
    rng = np.random.default_rng(11)
    xy, bid, *_ = synth_small.sample_points(rng, 3000)
    venue = xy[bid == int(np.bincount(bid[bid >= 0]).argmax())]
    stream, off = [], 0
    for second in range(10):
        req = xy[off:off + 200]
        off += 200
        if second >= 4:
            req = np.concatenate([req, venue[rng.integers(0, len(venue),
                                                          100)]])
        stream.append((float(second), req))
    stream.append((32.0, xy[:1]))
    (j_srv, t_srv), (j_res, t_res) = _serve_both(
        fast_engines, stream, cache, window_s=8.0, slide_s=2.0, k_anon=5,
        sketch_bits=2048)
    for a, b in zip(j_res, t_res):
        for field in ("state", "county", "block", "region"):
            np.testing.assert_array_equal(getattr(a, field),
                                          getattr(b, field))
    j_snap, t_snap = j_srv.snapshot_analytics(), t_srv.snapshot_analytics()
    assert t_snap == j_snap
    region = t_snap["regions"][0]
    assert region["finalized_total"] > 0
    assert region["observed"] == sum(len(p) for _, p in stream)


@pytest.mark.parametrize("cache", [True, False])
def test_served_equals_direct_sync(fast_engines, points_small, cache):
    """After synchronous submits the open window's counts equal a direct
    engine assign + bincount, cache hits and device answers alike."""
    _, t_eng = fast_engines
    pts = points_small[0][:1500]
    server = GeoServer(t_eng, ServeConfig(
        cache=cache, analytics=AnalyticsConfig(
            window_s=60.0, sketch_bits=512, clock=_clock([1000.0]))))
    direct = t_eng.assign(pts).block.numpy()
    for i in range(0, len(pts), 250):
        server.submit(pts[i:i + 250])
    ana = server.regions[0].analytics
    cur = ana.current()
    np.testing.assert_array_equal(
        cur.counts, np.bincount(direct[direct >= 0], minlength=ana.n_blocks))
    assert cur.n_events == int((direct >= 0).sum())
    np.testing.assert_array_equal(
        ana.areas, polygon_areas(t_eng.census.blocks))


def test_serving_analytics_observability(fast_engines, points_small):
    _, t_eng = fast_engines
    server = GeoServer(t_eng, ServeConfig(analytics=AnalyticsConfig(
        window_s=60.0, sketch_bits=512, clock=_clock([1000.0]))))
    server.submit(points_small[0][:300])
    snap = server.snapshot_analytics()
    assert snap is not None and len(snap["regions"]) == 1
    assert snap["regions"][0]["observed"] == 300
    text = server.metrics_text()
    for needle in ("analytics_points", "analytics_open_panes",
                   "analytics_windows_finalized", "analytics_late_dropped",
                   "analytics_suppressed_blocks", "analytics_observe"):
        assert needle in text, needle
    assert GeoServer(t_eng, ServeConfig()).snapshot_analytics() is None


def test_serving_analytics_unowned_points_not_folded(fast_engines):
    _, t_eng = fast_engines
    server = GeoServer(t_eng, ServeConfig(analytics=AnalyticsConfig(
        window_s=60.0, sketch_bits=512, clock=_clock([1000.0]))))
    res = server.submit(np.full((8, 2), 500.0, np.float32))
    assert (res.region == -1).all()
    snap = server.snapshot_analytics()["regions"][0]
    assert snap["observed"] == 0 and snap["off_map"] == 0
    assert snap["open"] is None


# ----------------------------------------------- the CUDA kernel
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CUDA)
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SEGMENT_CASES))
def test_cuda_segment_reduce_matches_twin(cuda_device, case):
    """On the card: count / min / max and integer-valued sums equal the
    oracle; float sums within SUM_RTOL; a second launch is bit-equal."""
    ids, vals, s, kind = _segment_inputs(case)
    t_ids = torch.from_numpy(ids).to(cuda_device)
    t_vals = torch.from_numpy(vals).to(cuda_device)
    got = ops.segment_reduce(t_ids, t_vals, n_segments=s)
    again = ops.segment_reduce(t_ids, t_vals, n_segments=s)
    _assert_matches(got, ref.np_segment_reduce(ids, vals, s), kind)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["parked", "unparked", "no_values"])
def test_cuda_segment_wrapper_contract(cuda_device, kind):
    """On the card: -1 and >= S ids passed straight to the kernel land
    nowhere, and a None value column is never read; both equal the
    oracle."""
    ids, vals, s = _wrapper_inputs(kind)
    got = segment.segment_reduce_sorted(
        torch.from_numpy(ids).to(cuda_device),
        None if vals is None else torch.from_numpy(vals).to(cuda_device), s)
    _assert_matches(got, ref.np_segment_reduce(ids, vals, s), "int")


# ------------------- the redesigned segment kernel's cases and wrapper
# The kernel's row tile (csrc/segment.cu kTile; the card's copy reports
# it through repro_segment_tile_rows) sizes the long-span case.
TILE_ROWS = 8192

# (n rows, n segments, id kind): one segment; more segments than rows; a
# row count that is no multiple of 4; one segment over more than 64 row
# tiles among uniform ones.
KERNEL_CASES = {
    "one_segment": (3001, 1, "mixed"),
    "more_segments_than_rows": (1003, 5000, "mixed"),
    "odd_rows": (70001, 100, "mixed"),
    "long_span": (1 << 20, 50, "long"),
}


def _kernel_case(case, kind):
    """Sorted, parked ids and (for ``kind`` "int" / "float") their
    values, straight to ``segment_reduce_sorted``."""
    n, s, ids_kind = KERNEL_CASES[case]
    rng = np.random.default_rng(list(KERNEL_CASES).index(case) + 40)
    ids = rng.integers(-2, s + 2, size=n)
    if ids_kind == "long":
        span = 64 * TILE_ROWS + 1237
        ids[(n - span) // 2:(n - span) // 2 + span] = s // 2
    ids = np.sort(np.where((ids < 0) | (ids >= s), s, ids)).astype(np.int32)
    vals = None if kind == "none" else (
        rng.integers(-50, 50, size=n) if kind == "int"
        else rng.random(n)).astype(np.float32)
    return ids, vals, s


@pytest.mark.parametrize("kind", ["int", "float", "none"])
@pytest.mark.parametrize("case", list(KERNEL_CASES))
def test_segment_twin_on_kernel_cases(case, kind):
    """The wrapper (the twin on the CPU) on the kernel's new cases against
    the numpy oracle and the JAX ``ref`` backend; the long span really
    covers more than 64 row tiles."""
    ids, vals, s = _kernel_case(case, kind)
    got = segment.segment_reduce_sorted(
        torch.from_numpy(ids), None if vals is None else torch.from_numpy(
            vals), s)
    _assert_matches(got, ref.np_segment_reduce(ids, vals, s), kind)
    jref = j_ops.segment_reduce(jnp.asarray(ids),
                                None if vals is None else jnp.asarray(vals),
                                n_segments=s, backend="ref")
    _assert_matches(got, jref, kind)
    if case == "long_span":
        rows = np.flatnonzero(ids == s // 2)
        assert rows[-1] // TILE_ROWS - rows[0] // TILE_ROWS > 64
    if case == "more_segments_than_rows":
        assert s > len(ids)


def test_segment_twin_on_a_column_off_16_bytes():
    """A value column that starts 4 bytes into a buffer gives the aligned
    column's answer (the card's kernel reads it row by row)."""
    ids, vals, s = _kernel_case("odd_rows", "float")
    buf = torch.empty(len(vals) + 1)
    buf[1:] = torch.from_numpy(vals)
    view = buf[1:]
    assert view.data_ptr() % 16 != 0
    t_ids = torch.from_numpy(ids)
    for a, b in zip(segment.segment_reduce_sorted(t_ids, view, s),
                    segment.segment_reduce_sorted(
                        t_ids, torch.from_numpy(vals), s)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n, s, values, want", [
    (1 << 24, 3072, False, {}),
    (0, 16, True, {}),
    (1 << 24, 3072, True, {"start": ((3073,), torch.int64),
                           "partials": ((2048, 2, 3), torch.float32),
                           "tickets": ((3072,), torch.int32)}),
    (8193, 1, True, {"start": ((2,), torch.int64),
                     "partials": ((2, 2, 3), torch.float32),
                     "tickets": ((1,), torch.int32)}),
    (1, 5000, True, {"start": ((5001,), torch.int64),
                     "partials": ((1, 2, 3), torch.float32),
                     "tickets": ((5000,), torch.int32)}),
])
def test_segment_scratch_shapes(n, s, values, want):
    """Counts (and an empty column) take no scratch; a value column takes
    the bounds, two partials a tile and a ticket a segment."""
    assert segment.scratch_shapes(n, s, TILE_ROWS, values) == want


@pytest.mark.parametrize("bad", ["dtype", "shape", "values", "segments"])
def test_segment_check_args_refuses(bad):
    """The kernel's argument checks (run here on CPU tensors)."""
    ids = torch.zeros(8, dtype=torch.int32)
    vals = torch.zeros(8)
    s = 4
    if bad == "dtype":
        ids = ids.long()
    elif bad == "shape":
        ids = ids.reshape(2, 4)
    elif bad == "values":
        vals = torch.zeros(7)
    else:
        s = -1
    with pytest.raises(ValueError):
        segment.check_args(ids, vals, s)
    segment.check_args(torch.zeros(8, dtype=torch.int32), None, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int", "float", "none"])
@pytest.mark.parametrize("case", list(KERNEL_CASES))
def test_cuda_segment_kernel_cases(cuda_device, case, kind):
    """On the card: the new cases equal the oracle (f32 sums within
    SUM_RTOL), a second launch is bit-equal, a call launches once without
    values and twice with, and a column 4 bytes into a buffer gives the
    aligned column's bits."""
    from repro_torch.kernels import _build
    ids, vals, s = _kernel_case(case, kind)
    if case == "long_span":
        assert _build.load().repro_segment_tile_rows() == TILE_ROWS
    t_ids = torch.from_numpy(ids).to(cuda_device)
    t_vals = None if vals is None else torch.from_numpy(vals).to(cuda_device)
    _build.reset_launches()
    got = segment.segment_reduce_sorted(t_ids, t_vals, s)
    assert _build.LAUNCHES["segment_reduce_sorted"] == (1 if vals is None
                                                        else 2)
    again = segment.segment_reduce_sorted(t_ids, t_vals, s)
    _assert_matches(got, ref.np_segment_reduce(ids, vals, s), kind)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    if t_vals is not None:
        buf = torch.empty(len(vals) + 1, device=cuda_device)
        buf[1:] = t_vals
        for a, b in zip(segment.segment_reduce_sorted(t_ids, buf[1:], s),
                        got):
            assert torch.equal(a, b)

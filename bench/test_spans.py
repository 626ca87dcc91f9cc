"""CPU tests of ``bench/spans.py``: device time, host syncs and idle gaps
put down to the program's ``geo.*`` spans, on synthetic Chrome-trace
events and on a CPU profile of the program's engine."""
from __future__ import annotations

import os

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile, record_function

from bench import spans, trace as trace_mod

HOST = {"pid": 1, "tid": 1}
DEV = {"pid": 0, "tid": 7}


def _x(cat, name, ts, dur, corr=None, **where):
    e = dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, **(where or HOST))
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _events(with_spans=True):
    """Two batches.  The first: a locate kernel, a PIP kernel and a sync
    under ``geo.resolve.pip``, a copy under ``geo.resolve`` alone.  The
    second: a bbox kernel.  Then a sync in ``wait`` and a kernel with no
    launch event."""
    ev = [_x("user_annotation", trace_mod.STRETCH, 0, 200),
          _x("user_annotation", "assign", 0, 100),
          _x("cpu_op", "aten::where", 12, 6),
          _x("cuda_runtime", "cudaLaunchKernel", 14, 2, corr=1),
          _x("cpu_op", "aten::index", 41, 4),
          _x("cuda_runtime", "cudaLaunchKernel", 50, 2, corr=2),
          _x("cuda_runtime", "cudaStreamSynchronize", 60, 5, corr=3),
          _x("cuda_runtime", "cudaMemcpyAsync", 80, 2, corr=4),
          _x("user_annotation", "assign", 100, 50),
          _x("cuda_runtime", "cudaLaunchKernel", 110, 2, corr=5),
          _x("user_annotation", "wait", 150, 50),
          _x("cuda_runtime", "cudaStreamSynchronize", 160, 30, corr=6),
          _x("kernel", "locate_kernel", 20, 10, corr=1, **DEV),
          _x("kernel", "crossings_gathered_kernel", 55, 30, corr=2, **DEV),
          _x("gpu_memcpy", "Memcpy DtoD", 90, 5, corr=4, **DEV),
          _x("kernel", "bbox_kernel", 115, 10, corr=5, **DEV),
          _x("kernel", "orphan_kernel", 130, 10, corr=99, **DEV)]
    if with_spans:
        ev += [_x("user_annotation", "geo.assign", 5, 90),
               _x("user_annotation", "geo.fast.locate", 10, 20),
               _x("user_annotation", "geo.resolve", 40, 50),
               _x("user_annotation", "geo.resolve.pip", 45, 30),
               _x("user_annotation", "geo.assign", 102, 46),
               _x("user_annotation", "geo.simple.bbox", 105, 15)]
    return ev


@pytest.fixture
def tr():
    return spans.SpanTrace(_events(), {"crossings_gathered_kernel"})


def test_device_time_goes_to_nested_spans_by_correlation(tr):
    assert tr.span_device_us("geo.fast.locate") == 10
    assert tr.span_device_us("geo.resolve.pip") == 30
    assert tr.span_device_us("geo.resolve") == 35       # the pip kernel + copy
    assert tr.span_device_us("geo.resolve", "geo.resolve.pip") == 35
    assert tr.span_device_us("geo.assign") == 55
    assert tr.batches() == 2


def test_an_operation_without_a_launch_event_is_under_no_span(tr):
    every = tr.span_device_us("geo.assign", "geo.fast.locate",
                              "geo.resolve", "geo.simple.bbox")
    assert tr.device_us() - every == 10                 # the orphan kernel


def test_sync_calls_count_inside_geo_assign_only(tr):
    assert tr.span_calls(spans.SYNC_CALLS) == 1
    assert tr.span_calls(("cudaLaunchKernel",)) == 3
    assert sum(1 for n, _, _ in tr.runtime
               if n == "cudaStreamSynchronize") == 2


@pytest.mark.parametrize("names, per_batch", [
    (("geo.fast.locate",), 0.005),           # locate_ms
    (("geo.simple.bbox",), 0.005),           # bbox_ms
    (("geo.resolve",), 0.0175),              # resolve_ms
    (("geo.resolve.pip",), 0.015),           # pip_ms
])
def test_ms_per_batch(tr, names, per_batch):
    assert spans.ms_per_batch(tr, *names) == pytest.approx(per_batch)


def test_host_syncs_and_unspanned_share(tr):
    assert spans.host_syncs_per_batch(tr) == pytest.approx(0.5)
    # The copy (5 us) lies under geo.resolve but under no leaf span.
    assert spans.unspanned_share(tr) == pytest.approx(100 * 5 / 55)


def test_readings_are_none_without_spans_or_device_operations():
    plain = trace_mod.Trace(_events(), set())
    no_spans = spans.SpanTrace(_events(with_spans=False), set())
    no_device = spans.SpanTrace(
        [e for e in _events() if e["pid"] == HOST["pid"]], set())
    for t in (None, plain, no_spans, no_device):
        assert spans.ms_per_batch(t, "geo.resolve") is None
        assert spans.host_syncs_per_batch(t) is None
        assert spans.unspanned_share(t) is None


def test_gaps_name_the_innermost_program_span(tr):
    gaps = dict(tr.idle_gaps())
    assert gaps["assign/geo.resolve/aten::index"] == pytest.approx(25e-6)
    assert gaps["assign/geo.fast.locate"] == pytest.approx(20e-6)
    assert "wait" in gaps


def test_without_program_spans_the_reading_is_trace_s():
    ev = _events(with_spans=False)
    old, new = trace_mod.Trace(ev, {"bbox_kernel"}), \
        spans.SpanTrace(ev, {"bbox_kernel"})
    assert new.idle_gaps() == old.idle_gaps()
    assert new.top_ops() == old.top_ops()
    assert (new.device_us(), new.device_us(hand=True), new.busy_us()) == \
        (old.device_us(), old.device_us(hand=True), old.busy_us())


def test_a_cpu_profile_of_the_engine_holds_its_spans(tmp_path):
    """The program's spans, as torch.profiler exports them, are read on
    the stretch's thread; a CPU trace has no device operation, so the
    readings are None."""
    from repro_torch.core.engine import GeoEngine
    from repro_torch.core.synth import build_synth_census
    sc = build_synth_census(seed=0, n_states=2, counties_per_state=2,
                            blocks_per_county=4)
    eng = GeoEngine.build(sc.census, "simple", device="cpu")
    pts = sc.sample_points(np.random.default_rng(0), 256)[0]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(trace_mod.STRETCH):
            for _ in range(2):
                with record_function("assign"):
                    eng.assign(pts)
    path = os.path.join(tmp_path, "trace.json")
    prof.export_chrome_trace(path)
    tr = spans.SpanTrace.from_file(path, set())
    names = [n for n, _, _ in tr.spans]
    assert tr.batches() == 2
    assert names.count("geo.resolve.pip") == 6
    assert {"geo.simple.state", "geo.simple.bbox", "geo.simple.stats",
            "geo.resolve.compact"} <= set(names)
    assert spans.ms_per_batch(tr, "geo.resolve") is None

"""Observability subsystem: request tracing, per-stage latency
histograms, and profiler hooks for the geo serving stack (port of
src/repro/obs; DESIGN.md §15).

Public surface:

    from repro_torch.obs import Tracer            # per-request spans
    from repro_torch.obs import LatencyHistogram  # mergeable log buckets
    from repro_torch.obs import device_annotation # torch.profiler range
    from repro_torch.obs import start_profile, stop_profile

The tracer attaches to a server (``GeoServer(..., tracer=Tracer())``)
and exports both a raw span dump and a Chrome-trace file; the
histograms back ``ServerMetrics``' per-stage breakdown and its
Prometheus-style ``expose_text()``.
"""
from repro_torch.obs.hist import LatencyHistogram
from repro_torch.obs.profile import (device_annotation, profiler_available,
                                     start_profile, stop_profile)
from repro_torch.obs.trace import RequestTrace, Span, SpanBuffer, Tracer

__all__ = [
    "LatencyHistogram", "RequestTrace", "Span", "SpanBuffer", "Tracer",
    "device_annotation", "profiler_available", "start_profile",
    "stop_profile",
]

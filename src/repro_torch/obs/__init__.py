"""Observability subsystem: request tracing, per-stage latency
histograms, and profiler hooks for the geo serving stack (port of
src/repro/obs; DESIGN.md §15).

Public surface:

    from repro_torch.obs import Tracer            # per-request spans
    from repro_torch.obs import LatencyHistogram  # mergeable log buckets
    from repro_torch.obs import span              # torch.profiler range
    from repro_torch.obs import device_annotation # span + NVTX range
    from repro_torch.obs import start_profile, stop_profile

The tracer attaches to a server (``GeoServer(..., tracer=Tracer())``)
and exports both a raw span dump and a Chrome-trace file; the
histograms back ``ServerMetrics``' per-stage breakdown and its
Prometheus-style ``expose_text()``.

Where an assign's device time goes: capture with
``start_profile(logdir)`` / ``stop_profile()`` (or ``GeoServer``'s pair)
around the calls, then read ``<logdir>/trace.json``.  While a capture
runs, ``GeoEngine.assign`` names its phases with ``span``: ``geo.assign``
around the call, then ``geo.fast.locate``, ``geo.fast.onepass``,
``geo.fast.parents``, ``geo.simple.{state,county,block}`` with
``geo.simple.bbox`` and ``geo.simple.stats``, ``geo.hybrid.handoff``,
and ``geo.resolve`` with its ``compact`` / ``candidates`` / ``pip`` /
``scatter`` phases.  The ranges sit on the host thread beside the
kernels' launch events; a kernel belongs to the innermost range its
launch lies in (the launch and the kernel share a ``correlation`` id).
``scripts/torch_profile.py`` prints that split for each engine path.
With no capture running, ``span`` records nothing.
"""
from repro_torch.obs.hist import LatencyHistogram
from repro_torch.obs.profile import (device_annotation, profiler_available,
                                     span, start_profile, stop_profile)
from repro_torch.obs.trace import RequestTrace, Span, SpanBuffer, Tracer

__all__ = [
    "LatencyHistogram", "RequestTrace", "Span", "SpanBuffer", "Tracer",
    "device_annotation", "profiler_available", "span", "start_profile",
    "stop_profile",
]

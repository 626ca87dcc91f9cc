"""Streaming geo-assignment serving subsystem (port of src/repro/serving;
DESIGN.md §10, §14).

Public surface:

    from repro_torch.serving import GeoServer, ServeConfig          # sync
    from repro_torch.serving import AsyncGeoServer, FrontendConfig  # concurrent

plus the composable pieces for custom serving loops: ``MicroBatcher`` /
``QueueFull`` (thread-safe micro-batching + backpressure),
``HotCellCache`` / ``CellTable`` (exact hot-cell shortcut),
``ServerMetrics`` (live counters / per-stage latency histograms /
Prometheus-style exposition).  Observability (DESIGN.md §15) plugs in
via ``repro_torch.obs``: ``GeoServer(..., tracer=Tracer())`` records
per-request span timelines, ``GeoServer.metrics_text()`` exposes the
registry, and ``ServeConfig(trace_device=True)`` +
``start_profile``/``stop_profile`` capture named device traces.
Windowed streaming analytics (DESIGN.md §16) mounts behind the same
facade: ``ServeConfig(analytics=AnalyticsConfig(...))`` +
``GeoServer.snapshot_analytics()``.
"""
from repro_torch.analytics import AnalyticsConfig
from repro_torch.serving.batcher import (DEFAULT_BUCKETS, MicroBatch,
                                         MicroBatcher, QueueFull,
                                         bucket_for, pad_points)
from repro_torch.serving.cache import (CellTable, HotCellCache,
                                       np_extent_mask, np_quantize_codes)
from repro_torch.serving.frontend import AsyncGeoServer, FrontendConfig
from repro_torch.serving.metrics import LatencyWindow, ServerMetrics
from repro_torch.serving.server import GeoServer, ServeConfig, ServeResult

__all__ = [
    "AnalyticsConfig",
    "DEFAULT_BUCKETS", "MicroBatch", "MicroBatcher", "QueueFull",
    "bucket_for", "pad_points", "CellTable", "HotCellCache",
    "np_extent_mask", "np_quantize_codes", "LatencyWindow",
    "ServerMetrics", "GeoServer", "ServeConfig", "ServeResult",
    "AsyncGeoServer", "FrontendConfig",
]

"""GeoAnalytics: per-block aggregation + windowed streaming analytics
(port of src/repro/analytics; DESIGN.md §16).

Three layers: the segment-reduce kernel (``kernels/segment.py`` /
``ops.segment_reduce``), batch aggregation (``BlockAggregator``),
windowed streaming state (``WindowedAggregator``, numpy).  The serving
layer mounts the windowed layer behind ``ServeConfig(analytics=...)``.
"""
from repro_torch.analytics.aggregate import BlockAggregator
from repro_torch.analytics.sketch import DEF_BITS, DistinctSketch, splitmix64
from repro_torch.analytics.window import (AnalyticsConfig,
                                          WindowedAggregator,
                                          WindowSnapshot, WindowState)

__all__ = [
    "AnalyticsConfig",
    "BlockAggregator",
    "DEF_BITS",
    "DistinctSketch",
    "WindowSnapshot",
    "WindowState",
    "WindowedAggregator",
    "splitmix64",
]

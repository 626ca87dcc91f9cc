"""Built-in mapping strategies as registered plugins (port of
src/repro/core/strategies.py).

This slice ports the paper's fast cell index (§IV) and its one-pass
cascade variant; ``simple``, ``hybrid`` and ``sharded`` come with later
slices (``registry.NOT_PORTED``).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import fast as fast_mod
from repro_torch.core.registry import Strategy, register_strategy
from repro_torch.core.resolve import AssignResult, GeoStats


def _fast_result(sid, cid, bid, st) -> AssignResult:
    return AssignResult(sid, cid, bid, GeoStats(
        n_need=st["n_boundary"], n_pip=st["n_pip"],
        overflow=st["overflow"], extra=st))


@register_strategy("fast", needs=("fast",), needs_edge_pool=True)
class FastStrategy(Strategy):
    """The paper's §IV true-hit-filter cell index (cfg.mode picks exact /
    approx boundary handling)."""

    def pool_components(self, cfg):
        # Only exact mode runs candidate PIP (approx takes the centre
        # owner), so only it needs the edge pool.
        return ("fast",) if cfg.fused and cfg.mode == "exact" else ()

    def assign(self, indices, points, cfg) -> AssignResult:
        return _fast_result(*fast_mod.assign_fast(indices.fast, points,
                                                   cfg.fast_cfg()))


@register_strategy("fast_onepass", needs=("fast",), needs_edge_pool=True)
class FastOnepassStrategy(FastStrategy):
    """The one-pass cascade kernel: ``fast`` with ``mode="exact",
    fused="onepass"`` pinned, under its own name."""

    def pool_components(self, cfg):
        return ("fast",)

    def assign(self, indices, points, cfg) -> AssignResult:
        fcfg = dataclasses.replace(cfg.fast_cfg(), mode="exact",
                                   fused="onepass")
        return _fast_result(*fast_mod.assign_fast(indices.fast, points,
                                                  fcfg))

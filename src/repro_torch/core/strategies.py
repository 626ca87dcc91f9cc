"""Built-in mapping strategies as registered plugins (port of
src/repro/core/strategies.py).

The paper's simple cascade (§III), the fast cell index (§IV), its
one-pass cascade variant, and the hybrid interior/cascade split; the
``sharded`` strategy comes with a later slice (``registry.NOT_PORTED``).
Each plugin is a thin driver over ``core.resolve.resolve_candidates``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import fast as fast_mod
from repro_torch.core import simple as simple_mod
from repro_torch.core.compact import (capacity_for, compact_indices,
                                      scatter_filled)
from repro_torch.core.fast import FastIndex, cell_values, parents_of
from repro_torch.core.registry import Strategy, register_strategy
from repro_torch.core.resolve import AssignResult, GeoStats
from repro_torch.core.simple import SimpleConfig, SimpleIndex
from repro_torch.kernels import ops


def _fast_result(sid, cid, bid, st) -> AssignResult:
    return AssignResult(sid, cid, bid, GeoStats(
        n_need=st["n_boundary"], n_pip=st["n_pip"],
        overflow=st["overflow"], extra=st))


@register_strategy("simple", needs=("simple",), needs_edge_pool=True)
class SimpleStrategy(Strategy):
    """The paper's §III hierarchical bbox cascade."""

    def assign(self, indices, points, cfg) -> AssignResult:
        sid, cid, bid, st = simple_mod.assign_simple(
            indices.simple, points, cfg.simple_cfg())
        levels = simple_mod.LEVELS
        return AssignResult(sid, cid, bid, GeoStats(
            n_need=sum(st[l]["n_multi"] for l in levels),
            n_pip=sum(st[l]["n_pip"] for l in levels),
            overflow=sum(st[l]["overflow"] for l in levels),
            extra=st))


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


def _assign_hybrid(findex: FastIndex, sindex: SimpleIndex,
                   points: torch.Tensor, scfg: SimpleConfig,
                   cap_frac: float):
    """Hybrid strategy: interior true hits from the cell index; boundary
    points re-resolved through the hierarchical cascade."""
    n = points.shape[0]
    val = cell_values(findex, points)
    bid = torch.where(val >= 0, val, -1)
    need = (val < 0) & (val > fast_mod.OUTSIDE)      # boundary cells
    n_boundary = need.sum()

    cap = capacity_for(n, cap_frac)
    idx, slot_ok = compact_indices(need, cap)
    sub_need = need[idx] & slot_ok
    # Unfilled compaction slots alias row 0: the cascade gets FAR points
    # there (and on non-boundary rows), so its stats count only real
    # boundary work and a padded batch reports the stats of its valid
    # prefix.  Only sub_need rows' cascade output is kept below.
    sub_pts = torch.where(sub_need[:, None], points[idx], ops.FAR)
    _, _, sub_bid, sub_stats = simple_mod.cascade_assign(sindex, sub_pts,
                                                         scfg)
    bid = scatter_filled(bid, idx, slot_ok,
                         torch.where(sub_need & (sub_bid >= 0), sub_bid,
                                     bid[idx]))
    overflow = n_boundary - sub_need.sum()
    if findex.cand.shape[0] > 0:
        # Cascade misses and capacity overflow degrade to the
        # centre-owner candidate (the fast-approx answer).
        brow = (-(val + 1)).clamp(0, findex.cand.shape[0] - 1)
        bid = torch.where(need & (bid < 0), findex.cand[brow, 0], bid)

    cid, sid = parents_of(findex, bid)
    n_pip = sum(lvl["n_pip"] for lvl in sub_stats.values())
    stats = {"n_boundary": n_boundary, "n_pip": n_pip,
             "overflow": overflow, "cascade": sub_stats}
    return sid, cid, bid, stats


@register_strategy("hybrid", needs=("simple", "fast"), needs_edge_pool=True)
class HybridStrategy(Strategy):
    """Fast cell lookup for interior true hits; boundary and overflow
    points go through the simple cascade's hierarchical PIP instead of
    the flat candidate lists."""

    def pool_components(self, cfg):
        # The cascade does all candidate PIP in hybrid mode; the fast
        # index's own pool is never read.
        return ("simple",) if cfg.fused else ()

    def assign(self, indices, points, cfg) -> AssignResult:
        return _fast_result(*_assign_hybrid(
            indices.fast, indices.simple, points, cfg.hybrid_cascade_cfg(),
            cfg.cap_boundary))

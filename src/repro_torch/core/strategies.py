"""Built-in mapping strategies as registered plugins (port of
src/repro/core/strategies.py).

The paper's simple cascade (§III), the fast cell index (§IV), its
one-pass cascade variant, the hybrid interior/cascade split, and the
dispatch-routed Morton-sharded lookup over a ``launch.mesh.Mesh``.
Each plugin is a thin driver over ``core.resolve.resolve_candidates``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import fast as fast_mod
from repro_torch.core import simple as simple_mod
from repro_torch.core.compact import (capacity_for, compact_indices,
                                      scatter_filled)
from repro_torch.core.distributed import ShardedFastIndex, local_lookup
from repro_torch.core.fast import (FastConfig, FastIndex, cell_values,
                                   parents_of, quantize_codes)
from repro_torch.core.registry import Strategy, register_strategy
from repro_torch.core.resolve import AssignResult, GeoStats
from repro_torch.core.simple import SimpleConfig, SimpleIndex
from repro_torch.distributed.dispatch import (plan_routes, scatter_to_buckets,
                                              slot_tables)
from repro_torch.kernels import ops
from repro_torch.obs.profile import span


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
        with span("geo.simple.stats"):
            stats = GeoStats(
                n_need=sum(st[l]["n_multi"] for l in levels),
                n_pip=sum(st[l]["n_pip"] for l in levels),
                overflow=sum(st[l]["overflow"] for l in levels),
                extra=st)
        return AssignResult(sid, cid, bid, stats)


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
    with span("geo.fast.locate"):
        val = cell_values(findex, points)
        bid = torch.where(val >= 0, val, -1)
        need = (val < 0) & (val > fast_mod.OUTSIDE)      # boundary cells
        n_boundary = need.sum()

    cap = capacity_for(n, cap_frac)
    with span("geo.hybrid.handoff"):
        idx, slot_ok = compact_indices(need, cap)
        sub_need = need[idx] & slot_ok
        # Unfilled compaction slots alias row 0: the cascade gets FAR
        # points there (and on non-boundary rows), so its stats count
        # only real boundary work and a padded batch reports the stats of
        # its valid prefix.  Only sub_need rows' cascade output is kept
        # below.
        sub_pts = torch.where(sub_need[:, None], points[idx], ops.FAR)
    _, _, sub_bid, sub_stats = simple_mod.cascade_assign(sindex, sub_pts,
                                                         scfg)
    with span("geo.hybrid.handoff"):
        bid = scatter_filled(bid, idx, slot_ok,
                             torch.where(sub_need & (sub_bid >= 0), sub_bid,
                                         bid[idx]))
        overflow = n_boundary - sub_need.sum()
        if findex.cand.shape[0] > 0:
            # Cascade misses and capacity overflow degrade to the
            # centre-owner candidate (the fast-approx answer).
            brow = (-(val + 1)).clamp(0, findex.cand.shape[0] - 1)
            bid = torch.where(need & (bid < 0), findex.cand[brow, 0], bid)
        n_pip = sum(lvl["n_pip"] for lvl in sub_stats.values())

    cid, sid = parents_of(findex, bid)
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


def _sharded_assign(sidx: ShardedFastIndex, points: torch.Tensor, mesh,
                    cfg: FastConfig, capacity: int, cap_pip: int):
    """Dispatch-routed sharded lookup: bucket points by owning Morton
    shard, fill this rank's capacity bucket, look it up against this
    rank's shard, and gather the results back by buffer slot.

    Every rank computes the same plan from the same whole batch and makes
    the same collectives in the same order, whatever its bucket holds."""
    n = points.shape[0]
    s = sidx.n_shards
    m = mesh.coords["model"]
    codes = quantize_codes(sidx.quant, sidx.max_level, points)
    owner = (torch.searchsorted(sidx.range_lo, codes, right=True) - 1
             ).clamp(0, s - 1).int()
    plan = plan_routes(owner, s, capacity)
    item_for_slot, _ = slot_tables(plan, s, capacity)        # [S*cap]
    ok = item_for_slot >= 0
    # Off-extent points carry border-clipped codes (see quantize_codes);
    # deactivate their slots so they come back -1, not a border block.
    ext = fast_mod.extent_mask(sidx.quant, sidx.max_level, points)
    mine = item_for_slot.view(s, capacity)[m]
    pts_loc = scatter_to_buckets(plan, points, 1, capacity,
                                 item_for_slot=mine)
    ok_loc = ok.view(s, capacity)[m] & ext[mine.clamp(0, n - 1)]
    lo, hi, val, cand = sidx.shard(m)
    bid_loc, rs = local_lookup(
        sidx.block_edges, lo, hi, val, cand,
        quantize_codes(sidx.quant, sidx.max_level, pts_loc), pts_loc,
        cfg.mode, cap_pip, cfg.backend, active=ok_loc,
        edge_pool=sidx.edge_pool if cfg.fused else None)
    # The [S, capacity] buffer of every shard's answers: -1 but in this
    # rank's row, so a pmax over "model" concatenates the rows.
    bid_buf = torch.full((s, capacity), -1, dtype=torch.int32,
                         device=points.device)
    bid_buf[m] = bid_loc
    bid_buf = mesh.pmax(bid_buf, ("model",))
    n_need, n_pip, pip_of, p2_miss = mesh.psum(
        torch.stack([rs.n_need, rs.n_pip, rs.overflow,
                     rs.phase2_miss]).long(), ("model",)).unbind()

    dest = torch.where(ok, item_for_slot, n).long()
    bid = torch.full((n + 1,), -1, dtype=torch.int32, device=points.device)
    bid[dest] = bid_buf.reshape(-1)
    bid = bid[:n]
    cid, sid = parents_of(sidx, bid)
    stats = {"n_boundary": n_need, "n_pip": n_pip, "overflow": pip_of,
             "phase2_miss": p2_miss, "n_dropped": plan.n_dropped}
    return sid, cid, bid, stats


@register_strategy("sharded", supports_sharded=True, supports_padded=False)
class ShardedStrategy(Strategy):
    """Morton-sharded cell lookup routed through the capacity-bucketed
    dispatch shared with the MoE layer (DESIGN.md §6); every engine's
    ``assign_sharded`` resolves to this plugin.

    Capacity per shard is ``cap_shard * N / n_shards``: routing skew
    beyond it is dropped to bid -1 and counted (``extra["n_dropped"]``),
    as MoE drops tokens.  Ranks along "data" repeat the work (points
    are replicated there), so the counters sum over "model" only.
    """

    def assign_sharded(self, indices, points, mesh, cfg) -> AssignResult:
        if "model" not in mesh.axis_names:
            raise ValueError("assign_sharded expects a mesh with a "
                             "'model' axis")
        n = points.shape[0]
        n_shards = int(mesh.shape["model"])
        sidx = indices.sharded_index(
            n_shards, with_pool=bool(cfg.fused) and cfg.mode == "exact")
        capacity = capacity_for(n, cfg.cap_shard / n_shards)
        cap_pip = capacity_for(capacity, cfg.cap_boundary,
                               ceiling=capacity)
        sid, cid, bid, st = _sharded_assign(
            sidx, points, mesh, cfg.fast_cfg(), capacity, cap_pip)
        return AssignResult(sid, cid, bid, GeoStats(
            n_need=st["n_boundary"], n_pip=st["n_pip"],
            overflow=st["overflow"] + st["n_dropped"], extra=st))

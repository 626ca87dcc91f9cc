"""The paper's "simple" approach (§III): port of src/repro/core/simple.py.

Three-stage cascade: state -> county -> block.  At each level a point is
tested against the bounding boxes of the *children of its current
parent* (the hierarchy keeps candidate sets tiny).  Points inside
exactly one bbox are resolved at once; the rest go through the
crossing-number test against at most ``k_cand`` candidate polygons.

  * state level: ``ops.bbox_mask`` over all state boxes (the
    ``bbox_mask`` kernel on the card);
  * county and block levels: ``ops.bbox_select_children`` (the
    ``bbox_select_children`` kernel) reads each point's children and
    their boxes by id from the level's tables and gives its count, its
    pick and its first ``k_cand`` candidates, with no per-point copy of
    the boxes;
  * points in more than one box go through ``resolve_candidates``: a
    fixed-capacity compaction, then candidate PIP — the gathered path
    (``crossings_gathered``) or, with ``SimpleConfig.fused``, the
    candidate path over the level's edge pool (``crossings_candidates``).
    Overflow of a capacity is counted (stats ``overflow``), not hidden.

Plain eager PyTorch, on the device the index and points live on.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core.compact import capacity_for
from repro_torch.core.geometry import CensusMap, children_tables
from repro_torch.core.resolve import first_k_candidates, resolve_candidates
from repro_torch.kernels import ops
from repro_torch.obs.profile import span

# Tensor fields of SimpleIndex, in order (``from_numpy`` keys).
INDEX_FIELDS = ("state_bbox", "county_bbox", "block_bbox", "state_edges",
                "county_edges", "block_edges", "county_children",
                "block_children", "block_parent", "county_parent")
LEVELS = ("state", "county", "block")
# bbox of the sentinel row: xmin > xmax, so it never matches.
EMPTY_BOX = (1.0, 0.0, 1.0, 0.0)


@dataclasses.dataclass
class SimpleIndex:
    """Device-resident flattened census hierarchy.

    bbox tables carry one trailing sentinel row (empty box) so parent id
    -1 gathers a never-matching candidate; children tables carry a
    sentinel row of -1s for the same reason.
    """

    state_bbox: torch.Tensor       # [Ns+1, 4] f32 (sentinel last)
    county_bbox: torch.Tensor      # [Nc+1, 4]
    block_bbox: torch.Tensor       # [Nb+1, 4]
    state_edges: torch.Tensor      # [Ns, Es, 4] f32
    county_edges: torch.Tensor     # [Nc, Ec, 4]
    block_edges: torch.Tensor      # [Nb, Eb, 4]
    county_children: torch.Tensor  # [Ns+1, Cc] i32, -1 padded
    block_children: torch.Tensor   # [Nc+1, Cb] i32
    block_parent: torch.Tensor     # [Nb] i32 (county of each block)
    county_parent: torch.Tensor    # [Nc] i32
    state_pool: Any = None   # ops.EdgePools over the three *_edges tables
    county_pool: Any = None  # (the candidate PIP path; SimpleConfig.fused)
    block_pool: Any = None

    @property
    def device(self) -> torch.device:
        return self.state_bbox.device

    @classmethod
    def from_census(cls, census: CensusMap, pad_children: int = 128,
                    with_pools: bool = False, *,
                    device="cuda") -> "SimpleIndex":
        """Index of a host census on ``device``.  ``with_pools`` also
        packs the edge pools the fused path needs.  ``pad_children`` is
        accepted for the reference's signature and, as there, unused: the
        children tables are as wide as the widest family."""
        def bbox_with_sentinel(soup):
            return np.concatenate(
                [soup.bbox, np.array([EMPTY_BOX], np.float32)], 0)

        def children(soup, n_parents):
            ids, _ = children_tables(soup, n_parents)
            return np.concatenate(
                [ids, np.full((1, ids.shape[1]), -1, np.int32)], 0)

        arrays = {
            "state_bbox": bbox_with_sentinel(census.states),
            "county_bbox": bbox_with_sentinel(census.counties),
            "block_bbox": bbox_with_sentinel(census.blocks),
            "state_edges": ops.edges_from_soup_np(census.states.verts),
            "county_edges": ops.edges_from_soup_np(census.counties.verts),
            "block_edges": ops.edges_from_soup_np(census.blocks.verts),
            "county_children": children(census.counties,
                                        census.states.n_poly),
            "block_children": children(census.blocks,
                                       census.counties.n_poly),
            "block_parent": census.blocks.parent,
            "county_parent": census.counties.parent,
        }
        index = cls.from_numpy(arrays, device=device)
        return index.with_pools() if with_pools else index

    @classmethod
    def from_numpy(cls, arrays: dict, *, device="cuda") -> "SimpleIndex":
        """Index from host arrays: ``INDEX_FIELDS`` and, optionally, each
        pool's ``<level>_pool_blocks/first/count``.  Any index with the
        same arrays (e.g. one built by the JAX package) loads this way;
        the tensors are copies."""
        t = {f: torch.as_tensor(np.array(arrays[f]), device=device)
             for f in INDEX_FIELDS}
        pools = {}
        for lvl in LEVELS:
            if f"{lvl}_pool_blocks" in arrays:
                pools[f"{lvl}_pool"] = ops.EdgePool.from_numpy(
                    *(arrays[f"{lvl}_pool_{f}"]
                      for f in ("blocks", "first", "count")), device=device)
        return cls(**t, **pools)

    def with_pools(self, be: int = ops.DEF_BE) -> "SimpleIndex":
        """This index with the three edge pools packed at block size
        ``be`` from its own edge tables."""
        return dataclasses.replace(self, **{
            f"{lvl}_pool": ops.build_edge_pool(getattr(self, f"{lvl}_edges"),
                                               be=be)
            for lvl in LEVELS})


@dataclasses.dataclass(frozen=True)
class SimpleConfig:
    """Static cascade knobs."""

    k_cand: int = 4          # max PIP candidates per point per level
    cap_state: float = 0.25  # compaction capacity as a fraction of N
    cap_county: float = 0.5
    cap_block: float = 0.5
    backend: str | None = None  # kernel backend override
    fused: bool = False      # candidate PIP over the *_pool tables
    #                          instead of gather + pip_gathered per level


def _level_stats(rs) -> dict:
    """Per-level stats dict from a ResolveStats."""
    return {"n_multi": rs.n_need, "n_pip": rs.n_pip,
            "overflow": rs.overflow, "phase2_miss": rs.phase2_miss}


def _level_pass(points, parent, children_table, bbox_table, edges_table,
                cap: int, k_cand: int, backend, edge_pool=None):
    """One hierarchy level: bbox count/select, then the resolution core
    for points in more than one child bbox.

    points [N, 2]; parent [N] i32 id into the *parent* level (-1 =
    lost).  Returns (assign [N] i32 child ids, stats dict).
    """
    with span("geo.simple.bbox"):
        cnt, assign, first = ops.bbox_select_children(
            points, parent, children_table, bbox_table, k_cand,
            backend=backend)
        unresolved = cnt > 1

    # Points whose PIP finds nothing keep the bbox select (boundary
    # grazing: fallback="prior").
    assign, rs = resolve_candidates(points, lambda idx, _: first[idx],
                                    edges_table, unresolved, cap=cap,
                                    backend=backend, prior=assign,
                                    fallback="prior", edge_pool=edge_pool)
    return assign, _level_stats(rs)


def cascade_assign(index: SimpleIndex, points: torch.Tensor,
                   cfg: SimpleConfig):
    """The three-level cascade; the hybrid strategy embeds it.  Returns
    (state, county, block ids, per-level stats dict).  Each level is a
    ``geo.simple.<level>`` span holding ``geo.simple.bbox`` and
    ``geo.resolve``."""
    n = points.shape[0]
    backend = cfg.backend
    if cfg.fused and index.state_pool is None:
        raise ValueError("SimpleConfig.fused needs an index built with "
                         "with_pools=True (SimpleIndex.from_census)")
    pools = ((index.state_pool, index.county_pool, index.block_pool)
             if cfg.fused else (None, None, None))

    # --- Stage 1: states (flat bbox mask over all states) ---
    ns = index.state_bbox.shape[0] - 1
    with span("geo.simple.state"):
        with span("geo.simple.bbox"):
            mask = ops.bbox_mask(points, index.state_bbox[:ns],
                                 backend=backend)
            cnt = mask.sum(dim=1, dtype=torch.int32)
            iota = torch.arange(ns, dtype=torch.int32, device=points.device)
            sid = torch.where(mask != 0, iota[None, :], -1).amax(dim=1)
            unresolved = cnt > 1
        # State candidates ARE bbox slots: first_k over the flat mask rows.
        sid, rs1 = resolve_candidates(
            points, lambda idx, _: first_k_candidates(mask[idx], cfg.k_cand),
            index.state_edges, unresolved,
            cap=capacity_for(n, cfg.cap_state), backend=backend,
            prior=sid, fallback="prior", edge_pool=pools[0])

    # --- Stage 2: counties of the point's state ---
    with span("geo.simple.county"):
        cid, c_stats = _level_pass(points, sid, index.county_children,
                                   index.county_bbox, index.county_edges,
                                   capacity_for(n, cfg.cap_county),
                                   cfg.k_cand, backend, edge_pool=pools[1])

    # --- Stage 3: blocks of the point's county ---
    with span("geo.simple.block"):
        bid, b_stats = _level_pass(points, cid, index.block_children,
                                   index.block_bbox, index.block_edges,
                                   capacity_for(n, cfg.cap_block),
                                   cfg.k_cand, backend, edge_pool=pools[2])

    stats = {"state": _level_stats(rs1), "county": c_stats,
             "block": b_stats}
    return sid, cid, bid, stats


def assign_simple(index: SimpleIndex, points: torch.Tensor,
                  cfg: SimpleConfig = SimpleConfig()):
    """Map [N, 2] (lon, lat) points to (state, county, block) ids +
    stats."""
    return cascade_assign(index, points, cfg)

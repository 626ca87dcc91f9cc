"""Distributed geo-index lookup on ``torch.distributed`` (port of
src/repro/core/distributed.py; DESIGN.md §2 last row).

The paper's approximate index reaches ~90 GiB on one node (its Table I).
Sharding the cell table into contiguous Morton ranges, one per rank of
the mesh's "model" axis, removes that wall, while points stay
batch-sharded over ("pod", "data"):

  * every model rank holds its Morton slice of (cell_lo, cell_hi, val,
    cand) on its device; the block geometry, parents, quant vector and
    edge pool are replicated;
  * points are replicated over "model", so each rank resolves the points
    whose leaf code falls in its range, and one i32 ``pmax`` a point
    combines the ranks (no payload all-to-all);
  * the PIP fallback of boundary points runs on the owning rank with a
    fixed-capacity compaction, so exact-mode compute is sharded too.

``shard_covering`` splits a host CellCovering into equal-cell padded
slices; ``assign_fast_distributed`` is the mesh lookup (a
``launch.mesh.Mesh``; every rank passes the same whole batch).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core.cells import CellCovering
from repro_torch.core.compact import capacity_for
from repro_torch.core.fast import (FastConfig, extent_mask, parents_of,
                                   quant_for_extent, quantize_codes)
from repro_torch.core.geometry import CensusMap
from repro_torch.core.resolve import ResolveStats, resolve_candidates
from repro_torch.kernels import ops

INT_MAX = np.int32(2**31 - 1)
DATA_AXES = ("pod", "data")


@dataclasses.dataclass
class ShardedFastIndex:
    """Morton-range-sharded cell index.  The four shard tables are
    stacked [n_shards, ...] on the host; ``shard(s)`` moves one row to
    ``device`` (a rank asks only for its own).  The rest lives on the
    device, replicated."""

    cell_lo: torch.Tensor        # [S, Lmax] i32, host (padded INT_MAX)
    cell_hi: torch.Tensor        # [S, Lmax] i32, host
    cell_val: torch.Tensor       # [S, Lmax] i32, host
    cand: torch.Tensor           # [S, Cmax, K] i32, host
    range_lo: torch.Tensor       # [S] i32: first leaf code of each shard
    block_edges: torch.Tensor    # [Nb, Eb, 4] f32
    block_parent: torch.Tensor   # [Nb] i32
    county_parent: torch.Tensor  # [Nc] i32
    quant: torch.Tensor          # [4] f32
    edge_pool: Any = None        # ops.EdgePool (the fused path)
    max_level: int = 9
    n_shards: int = 16
    _rows: dict = dataclasses.field(default_factory=dict, init=False,
                                    repr=False, compare=False)

    @property
    def device(self) -> torch.device:
        return self.block_edges.device

    def index_bytes_per_shard(self) -> int:
        per = sum(t.numel() * t.element_size()
                  for t in (self.cell_lo, self.cell_hi, self.cell_val,
                            self.cand))
        return per // self.n_shards

    def shard(self, s: int):
        """(cell_lo, cell_hi, cell_val, cand) of shard ``s`` on the
        index's device, copied there on first use."""
        if s not in self._rows:
            self._rows[s] = tuple(
                t[s].to(self.device, copy=True)
                for t in (self.cell_lo, self.cell_hi, self.cell_val,
                          self.cand))
        return self._rows[s]


def shard_covering(cov: CellCovering, census: CensusMap, n_shards: int,
                   with_pool: bool = False, *, device="cuda"
                   ) -> ShardedFastIndex:
    """Split the covering into ``n_shards`` contiguous Morton slices with
    (approximately) equal cell counts, padded to a common length; the
    replicated arrays go to ``device``.  ``with_pool`` also builds the
    blocked-CSR edge pool the fused candidate-PIP path needs."""
    n = len(cov.lo)
    bounds = [int(round(i * n / n_shards)) for i in range(n_shards + 1)]
    lmax = max(bounds[i + 1] - bounds[i] for i in range(n_shards))
    cmax = max(int((cov.val[bounds[i]:bounds[i + 1]] < 0).sum())
               for i in range(n_shards))

    cell_lo = np.full((n_shards, lmax), INT_MAX, np.int32)
    cell_hi = np.full((n_shards, lmax), -1, np.int32)
    cell_val = np.full((n_shards, lmax), -1, np.int32)
    cand = np.full((n_shards, max(cmax, 1), cov.cand.shape[1]), -1, np.int32)
    range_lo = np.zeros((n_shards,), np.int32)
    for i in range(n_shards):
        a, b = bounds[i], bounds[i + 1]
        cell_lo[i, :b - a] = cov.lo[a:b]
        cell_hi[i, :b - a] = cov.hi[a:b]
        val = cov.val[a:b].copy()
        # Re-base boundary candidate rows into this shard's local table.
        is_b = val < 0
        local = np.arange(is_b.sum(), dtype=np.int32)
        cand[i, :len(local)] = cov.cand[-(val[is_b] + 1)]
        val[is_b] = -(local + 1)
        cell_val[i, :b - a] = val
        range_lo[i] = cov.lo[a]
    range_lo[0] = 0

    def on_device(a):
        return torch.as_tensor(np.array(a), device=device)

    block_edges = on_device(ops.edges_from_soup_np(census.blocks.verts))
    return ShardedFastIndex(
        cell_lo=torch.from_numpy(cell_lo), cell_hi=torch.from_numpy(cell_hi),
        cell_val=torch.from_numpy(cell_val), cand=torch.from_numpy(cand),
        range_lo=on_device(range_lo), block_edges=block_edges,
        block_parent=on_device(census.blocks.parent),
        county_parent=on_device(census.counties.parent),
        quant=on_device(quant_for_extent(cov.extent, cov.max_level)),
        edge_pool=ops.build_edge_pool(block_edges) if with_pool else None,
        max_level=cov.max_level, n_shards=n_shards)


def local_lookup(block_edges, lo, hi, val, cand, codes, points,
                 mode: str, cap: int, backend, active=None,
                 edge_pool=None):
    """Lookup of ``codes`` against ONE shard's table (padded rows inert).

    ``active`` optionally masks rows (off-extent points, empty dispatch
    slots).  Boundary points go through the shared resolution core
    (sequential schedule, centre-owner fallback); ``edge_pool`` routes
    their PIP through the candidate kernel.  Returns (bid, ResolveStats).
    """
    pos = (torch.searchsorted(lo, codes, right=True) - 1).clamp(
        0, lo.shape[0] - 1)
    found = (lo[pos] <= codes) & (codes <= hi[pos])
    if active is not None:
        found = found & active
    v = torch.where(found, val[pos], -INT_MAX)
    bid = torch.where(v >= 0, v, -1)
    is_b = found & (v < 0) & (v > -INT_MAX)
    brow = (-(v + 1)).clamp(0, cand.shape[0] - 1)
    if mode == "approx":
        bid = torch.where(is_b, cand[brow, 0], bid)
        zero = torch.zeros((), dtype=torch.int32, device=codes.device)
        return bid, ResolveStats(n_need=is_b.sum(), n_pip=zero,
                                 overflow=zero, phase2_miss=zero)
    return resolve_candidates(
        points, lambda i, _: cand[brow[i]], block_edges, is_b, cap=cap,
        backend=backend, prior=bid, fallback="first", edge_pool=edge_pool)


def assign_fast_distributed(idx: ShardedFastIndex, points: torch.Tensor,
                            mesh, cfg: FastConfig = FastConfig()):
    """Sharded-index lookup: [N, 2] points (the same whole batch on every
    rank) batch-sharded over ("pod", "data"), the index over "model".
    Returns (sid, cid, bid, stats) like ``assign_fast``, the full [N] ids
    on every rank."""
    if "model" not in mesh.axis_names:
        raise ValueError("assign_fast_distributed expects a mesh with a "
                         "'model' axis")
    if mesh.shape["model"] != idx.n_shards:
        raise ValueError(f"index of {idx.n_shards} shards on a mesh whose "
                         f"'model' axis has {mesh.shape['model']} ranks")
    dp = tuple(a for a in DATA_AXES if a in mesh.axis_names)
    dp_size = mesh.axis_size(dp)
    n = points.shape[0]
    if n % dp_size:
        raise ValueError(f"{n} points do not split over {dp_size} data "
                         f"ranks")
    n_loc = n // dp_size
    cap = capacity_for(n_loc, cfg.cap_boundary)
    # Defense in depth for direct callers: the engine's sharded assign
    # builds the pool on demand (GeoIndexSet.sharded_index).
    if cfg.fused and cfg.mode == "exact" and idx.edge_pool is None:
        raise ValueError("FastConfig.fused needs an index built with "
                         "with_pool=True (shard_covering)")
    d = mesh.index(dp)
    pts_loc = points[d * n_loc:(d + 1) * n_loc]
    lo, hi, val, cand = idx.shard(mesh.coords["model"])
    codes = quantize_codes(idx.quant, idx.max_level, pts_loc)
    # Off-extent points quantize onto the border (see quantize_codes);
    # mask them so they resolve to -1 instead of a border-cell block.
    ext = extent_mask(idx.quant, idx.max_level, pts_loc)
    bid_loc, rs = local_lookup(
        idx.block_edges, lo, hi, val, cand, codes, pts_loc, cfg.mode, cap,
        cfg.backend, active=ext,
        edge_pool=idx.edge_pool if cfg.fused else None)
    # Each point is owned by exactly one shard and each batch row by one
    # data rank: every other rank leaves -1 there, so one pmax over all
    # axes both combines the shards and gathers the batch.
    out = torch.full((dp_size, n_loc), -1, dtype=torch.int32,
                     device=points.device)
    out[d] = bid_loc
    bid = mesh.pmax(out, ("model",) + dp).reshape(n)
    n_need, n_pip, overflow = mesh.psum(
        torch.stack([rs.n_need, rs.n_pip, rs.overflow]).long(),
        ("model",) + dp).unbind()
    cid, sid = parents_of(idx, bid)
    return sid, cid, bid, {"n_boundary": n_need, "n_pip": n_pip,
                           "overflow": overflow}

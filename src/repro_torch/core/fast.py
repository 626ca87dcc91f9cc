"""The "fast" approach (paper §IV): true-hit-filter cell lookup — port of
src/repro/core/fast.py.

Lookup pipeline per point (all vectorized):

  1. fixed-point quantize (lon, lat) -> (ix, iy) on the 2^L grid and
     Morton-interleave to a leaf code;
  2. locate the covering cell: top-grid bucket (first 2g bits; g = 0
     disables) then a fixed-iteration binary search over the sorted
     interval starts;
  3. interior cell  -> block id, done (the paper's "true hit");
     boundary cell  -> exact mode: crossing-number test against <= K
     candidates; approx mode: the centre-owner candidate.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core.cells import CellCovering, morton_np
from repro_torch.core.compact import capacity_for
from repro_torch.core.geometry import CensusMap
from repro_torch.core.resolve import onepass_stats, resolve_candidates
from repro_torch.kernels import ops
from repro_torch.kernels.cascade import OUTSIDE, morton
from repro_torch.kernels.ref import grid_coord
from repro_torch.obs.profile import span

# Tensor fields of FastIndex, in order (``from_numpy`` keys).
INDEX_FIELDS = ("cell_lo", "cell_hi", "cell_val", "cand", "top_start",
                "block_edges", "block_parent", "county_parent", "quant",
                "block_bbox")
POOL_FIELDS = ("blocks", "first", "count")


@dataclasses.dataclass
class FastIndex:
    """Device-resident cell index (+ block geometry for exact mode)."""

    cell_lo: torch.Tensor       # [n_cells] i32 sorted
    cell_hi: torch.Tensor       # [n_cells] i32 inclusive ends
    cell_val: torch.Tensor      # [n_cells] i32
    cand: torch.Tensor          # [n_boundary, K] i32
    top_start: torch.Tensor     # [4^g + 1] i32 — bucket ranges
    block_edges: torch.Tensor   # [Nb, Eb, 4] f32 — exact-mode PIP
    block_parent: torch.Tensor  # [Nb] i32
    county_parent: torch.Tensor  # [Nc] i32
    quant: torch.Tensor         # [4] f32: (x0, y0, sx, sy)
    edge_pool: Any = None       # ops.EdgePool over the same blocks
    block_bbox: Any = None      # [Nb, 4] f32 (xmin, xmax, ymin, ymax)
    max_level: int = 9
    gbits: int = 0
    search_iters: int = 32

    @property
    def device(self) -> torch.device:
        return self.cell_lo.device

    def nbytes(self) -> int:
        """Bytes of the cell lookup's arrays (``repro``'s ``nbytes``: the
        cells, their candidate lists and the top grid)."""
        return sum(t.numel() * t.element_size()
                   for t in (self.cell_lo, self.cell_hi, self.cell_val,
                             self.cand, self.top_start))

    @classmethod
    def from_covering(cls, cov: CellCovering, census: CensusMap,
                      gbits: int = 4, with_pool: bool = False, *,
                      device="cuda") -> "FastIndex":
        """gbits = quadtree levels resolved by the direct-indexed top grid
        (2*gbits key bits).  ``with_pool`` also builds the blocked-CSR
        edge pool the candidate-PIP and one-pass paths need."""
        if not 0 <= gbits <= cov.max_level:
            raise ValueError(f"gbits {gbits} outside [0, max_level "
                             f"{cov.max_level}]")
        nb = 1 << (2 * gbits)
        shift = 2 * (cov.max_level - gbits)
        # Bucket b covers leaf codes [b << shift, (b+1) << shift); its
        # search range is [starts[b]-1, starts[b+1]).
        starts = np.searchsorted(cov.lo, np.arange(nb + 1, dtype=np.int64)
                                 << shift, side="left").astype(np.int32)
        max_span = int(np.max(starts[1:] - np.maximum(starts[:-1] - 1, 0))) \
            if len(cov.lo) else 1
        iters = max(1, int(np.ceil(np.log2(max(max_span, 2)))))
        block_edges = ops.edges_from_soup_np(census.blocks.verts)
        arrays = {
            "cell_lo": cov.lo, "cell_hi": cov.hi, "cell_val": cov.val,
            "cand": cov.cand, "top_start": starts,
            "block_edges": block_edges,
            "block_parent": census.blocks.parent,
            "county_parent": census.counties.parent,
            "quant": quant_for_extent(cov.extent, cov.max_level),
            "block_bbox": np.asarray(census.blocks.bbox, np.float32),
        }
        index = cls.from_numpy(arrays, max_level=cov.max_level, gbits=gbits,
                               search_iters=iters, device=device)
        if with_pool:
            index.edge_pool = ops.build_edge_pool(index.block_edges)
        return index

    @classmethod
    def from_numpy(cls, arrays: dict, *, max_level: int, gbits: int,
                   search_iters: int, device="cuda") -> "FastIndex":
        """Index from host arrays: ``INDEX_FIELDS`` and, optionally, the
        edge pool's ``edge_pool_blocks/first/count``.  Any index with the
        same arrays (e.g. one built by the JAX package) loads this way,
        each array passed through ``np.asarray``; the tensors are copies."""
        def tensor(a):
            return torch.as_tensor(np.array(a), device=device)

        t = {f: tensor(arrays[f]) for f in INDEX_FIELDS}
        pool = None
        if "edge_pool_blocks" in arrays:
            pool = ops.EdgePool.from_numpy(
                *(arrays[f"edge_pool_{f}"] for f in POOL_FIELDS),
                device=device)
        return cls(**t, edge_pool=pool, max_level=max_level, gbits=gbits,
                   search_iters=search_iters)


def unpart1by1(x: torch.Tensor) -> torch.Tensor:
    """Gather the even bit positions of ``x`` into its low 16 bits (the
    inverse of ``kernels.cascade.part1by1``)."""
    x = x & 0x55555555
    x = (x | (x >> 1)) & 0x33333333
    x = (x | (x >> 2)) & 0x0F0F0F0F
    x = (x | (x >> 4)) & 0x00FF00FF
    x = (x | (x >> 8)) & 0x0000FFFF
    return x


def demorton(code: torch.Tensor):
    """Inverse of ``morton``: int32 leaf codes -> (ix, iy) grid
    coordinates."""
    return unpart1by1(code), unpart1by1(code >> 1)


def quant_for_extent(extent, max_level: int) -> np.ndarray:
    """THE quant vector: [4] f32 = (x0, y0, sx, sy) with s = 2^L / span."""
    x0, x1, y0, y1 = extent
    n = 1 << max_level
    return np.array([x0, y0, n / (x1 - x0), n / (y1 - y0)], np.float32)


def quantize_codes(quant: torch.Tensor, max_level: int,
                   points: torch.Tensor) -> torch.Tensor:
    """Fixed-point quantize + Morton-interleave [N, 2] points to leaf
    codes given the quant params [4] = (x0, y0, sx, sy).

    Off-extent coordinates CLAMP onto the grid border (before the int
    cast, NaN -> 0), so every caller that turns a code into a block id
    must also apply ``extent_mask``.
    """
    nmax = (1 << max_level) - 1
    ix = grid_coord((points[:, 0] - quant[0]) * quant[2], nmax)
    iy = grid_coord((points[:, 1] - quant[1]) * quant[3], nmax)
    return morton(ix, iy)


def extent_mask(quant: torch.Tensor, max_level: int,
                points: torch.Tensor) -> torch.Tensor:
    """[N] bool — True where the point lies inside the quantization
    extent (the map bbox)."""
    n = 1 << max_level
    fx = (points[:, 0] - quant[0]) * quant[2]
    fy = (points[:, 1] - quant[1]) * quant[3]
    return (fx >= 0) & (fx < n) & (fy >= 0) & (fy < n)


def np_quantize_codes(quant, max_level: int, points) -> np.ndarray:
    """Host (numpy) mirror of ``quantize_codes``, op for op in fp32."""
    n = 1 << max_level
    xy = np.asarray(points, np.float32)
    q = np.asarray(quant, np.float32)
    with np.errstate(invalid="ignore", over="ignore"):
        fx = (xy[:, 0] - q[0]) * q[2]
        fy = (xy[:, 1] - q[1]) * q[3]
        ix = np.clip(np.trunc(fx), 0, n - 1).astype(np.int32)
        iy = np.clip(np.trunc(fy), 0, n - 1).astype(np.int32)
    return morton_np(ix, iy).astype(np.int32)


def np_extent_mask(quant, max_level: int, points) -> np.ndarray:
    """Host (numpy) mirror of ``extent_mask``."""
    n = 1 << max_level
    xy = np.asarray(points, np.float32)
    q = np.asarray(quant, np.float32)
    fx = (xy[:, 0] - q[0]) * q[2]
    fy = (xy[:, 1] - q[1]) * q[3]
    return (fx >= 0) & (fx < n) & (fy >= 0) & (fy < n)


def leaf_codes(index: FastIndex, points: torch.Tensor) -> torch.Tensor:
    return quantize_codes(index.quant, index.max_level, points)


def locate_cells(index: FastIndex, codes: torch.Tensor) -> torch.Tensor:
    """Index into cell_lo of the covering cell for each leaf code."""
    n_cells = index.cell_lo.shape[0]
    if index.gbits == 0:
        # Plain vectorized binary search over the full table.
        idx = torch.searchsorted(index.cell_lo, codes, right=True) - 1
    else:
        shift = 2 * (index.max_level - index.gbits)
        bucket = codes >> shift
        l = (index.top_start[bucket] - 1).clamp(min=0)
        h = index.top_start[bucket + 1]         # exclusive
        # Fixed-iteration searchsorted-right within [l, h).
        for _ in range(index.search_iters):
            active = l < h
            mid = (l + h) // 2
            go_right = index.cell_lo[mid.clamp(0, n_cells - 1)] <= codes
            nl = torch.where(active & go_right, mid + 1, l)
            nh = torch.where(active & ~go_right, mid, h)
            l, h = nl, nh
        idx = l - 1
    return idx.clamp(0, n_cells - 1)


@dataclasses.dataclass(frozen=True)
class FastConfig:
    mode: str = "exact"          # "exact" | "approx"
    cap_boundary: float = 0.25   # compaction capacity for boundary points
    backend: str | None = None
    fused: Any = False           # exact mode candidate-PIP data path:
    #                              False     — gather + pip_gathered;
    #                              True      — candidate PIP over the pool;
    #                              "onepass" — the one-pass cascade kernel.
    #                              Results are identical in all three.


def cell_values(index: FastIndex, points: torch.Tensor) -> torch.Tensor:
    """Covering-cell value per point: >= 0 interior block id, -(row+1)
    boundary candidate row, OUTSIDE off the map or in no cell."""
    codes = leaf_codes(index, points)
    cidx = locate_cells(index, codes)
    in_cell = ((index.cell_lo[cidx] <= codes)
               & (codes <= index.cell_hi[cidx]))   # gap => outside the map
    in_cell = in_cell & extent_mask(index.quant, index.max_level, points)
    return torch.where(in_cell, index.cell_val[cidx], OUTSIDE)


def parents_of(index, bid: torch.Tensor):
    """(county, state) ids of block ids via the parent tables."""
    with span("geo.fast.parents"):
        cid = torch.where(bid >= 0, index.block_parent[bid.clamp(min=0)],
                          -1)
        sid = torch.where(cid >= 0, index.county_parent[cid.clamp(min=0)],
                          -1)
    return cid, sid


def assign_fast_onepass(index: FastIndex, points: torch.Tensor,
                        cfg: FastConfig):
    """Exact-mode assignment through the one-pass cascade kernel: same
    assignments as the two-phase ``assign_fast`` path, and the same stats
    whenever its caps do not overflow (``onepass_stats``)."""
    if index.edge_pool is None or index.block_bbox is None:
        raise ValueError('FastConfig.fused="onepass" needs an index '
                         "built by FastIndex.from_covering with a pool "
                         "(with_pool=True / GeoIndexSet.ensure)")
    with span("geo.fast.onepass"):
        bid, flags, nrest, nskip = ops.assign_cascade(
            points, index.quant, index.cell_lo, index.cell_hi,
            index.cell_val, index.top_start, index.cand, index.block_bbox,
            index.edge_pool, max_level=index.max_level, gbits=index.gbits,
            search_iters=index.search_iters, backend=cfg.backend)
        stats = onepass_stats(flags, nrest, nskip)
    cid, sid = parents_of(index, bid)
    return sid, cid, bid, stats


def assign_fast(index: FastIndex, points: torch.Tensor,
                cfg: FastConfig = FastConfig()):
    """Map [N, 2] points -> (state, county, block ids, stats)."""
    n = points.shape[0]
    if cfg.fused and cfg.mode == "exact" and index.edge_pool is None:
        raise ValueError("FastConfig.fused needs an index built with "
                         "with_pool=True (FastIndex.from_covering)")
    if cfg.fused == "onepass" and cfg.mode == "exact":
        return assign_fast_onepass(index, points, cfg)
    has_cand = index.cand.shape[0] > 0
    with span("geo.fast.locate"):
        val = cell_values(index, points)
        brow = (-(val + 1)).clamp(0, max(index.cand.shape[0] - 1, 0))
        bid = torch.where(val >= 0, val, -1)
        need = (val < 0) & (val > OUTSIDE)
        zero = torch.zeros((), dtype=torch.int32, device=points.device)
        n_boundary = need.sum()
        if has_cand and cfg.mode == "approx":
            # Centre-owner candidate; error <= leaf cell diagonal.
            bid = torch.where(need, index.cand[brow, 0], bid)
    n_pip, overflow, phase2_miss = zero, zero, zero

    if has_cand and cfg.mode != "approx":
        # Two-phase resolution: slot 0 (the centre owner) for every
        # boundary point, slots 1..K-1 for the slot-0 misses; unmatched
        # points fall back to the centre owner.
        bid, rs = resolve_candidates(
            points, lambda idx, _: index.cand[brow[idx]],
            index.block_edges, need,
            cap=capacity_for(n, cfg.cap_boundary),
            backend=cfg.backend, prior=bid, fallback="first",
            two_phase=True,
            edge_pool=index.edge_pool if cfg.fused else None)
        n_pip, overflow = rs.n_pip, rs.overflow
        phase2_miss = rs.phase2_miss

    cid, sid = parents_of(index, bid)
    stats = {"n_boundary": n_boundary, "n_pip": n_pip, "overflow": overflow,
             "phase2_miss": phase2_miss}
    return sid, cid, bid, stats

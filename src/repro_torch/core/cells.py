"""Host-side quadtree cell covering builder (paper §IV, TPU-adapted).

Builds the *true-hit-filter* index: a non-overlapping hierarchical cell
covering of the census map where each cell either

  * lies fully inside one block polygon  -> interior cell (value = block id),
  * or touches >= 1 polygon boundaries   -> boundary cell (candidate list,
    centre-owner first), emitted only at ``max_level``.

Unlike the paper's per-polygon S2 coverings, we build ONE global covering
top-down (the census map is a partition, so cells never belong to two
interiors).  Each BFS node carries the candidate polygon ids and boundary
edge ids that survive its parent — the build is O(total cells visited), not
O(polygons x cells).

Cells are identified by Morton (Z-order) codes over a 2^L x 2^L grid in the
map's normalized [0,1)^2 coordinates.  A cell at level l with Morton prefix m
covers leaf codes [m << 2(L-l), (m+1) << 2(L-l)); the index is the sorted
array of these intervals — the TPU-native replacement for the paper's radix
trie (DESIGN.md §2).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.geometry import CensusMap, point_in_polygon_host


def part1by1_np(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.int64) & 0x0000FFFF
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    x = (x | (x << 1)) & 0x55555555
    return x


def morton_np(ix: np.ndarray, iy: np.ndarray) -> np.ndarray:
    return (part1by1_np(iy) << 1) | part1by1_np(ix)


def _seg_rect_intersect(x1, y1, x2, y2, rx0, rx1, ry0, ry1):
    """Vectorized segment-vs-rect intersection (Liang-Barsky clip).

    Endpoints on the rect boundary count as intersecting (conservative:
    over-marking a cell as boundary only costs a PIP test, never wrongness).
    """
    dx = x2 - x1
    dy = y2 - y1
    t0 = np.zeros_like(x1)
    t1 = np.ones_like(x1)
    ok = np.ones_like(x1, dtype=bool)
    for p, q in (((-dx), (x1 - rx0)), ((dx), (rx1 - x1)),
                 ((-dy), (y1 - ry0)), ((dy), (ry1 - y1))):
        r = np.where(p != 0, q / np.where(p == 0, 1.0, p), 0.0)
        # p == 0: parallel; reject iff the segment lies outside this slab.
        ok &= ~((p == 0) & (q < 0))
        is_entry = p < 0
        t0 = np.where((p != 0) & is_entry, np.maximum(t0, r), t0)
        t1 = np.where((p != 0) & ~is_entry, np.minimum(t1, r), t1)
    return ok & (t0 <= t1)


@dataclasses.dataclass
class CellCovering:
    """Flat covering arrays (host, numpy), sorted by ``lo``."""

    lo: np.ndarray          # [n_cells] int32 — leaf-code interval start
    hi: np.ndarray          # [n_cells] int32 — inclusive interval end
    val: np.ndarray         # [n_cells] int32 — >=0 block id, <0 -(cand_row+1)
    level: np.ndarray       # [n_cells] int8 — quadtree level of the cell
    cand: np.ndarray        # [n_boundary, max_cand] int32, -1 padded
    max_level: int
    extent: tuple           # (x0, x1, y0, y1) of the map
    n_interior: int
    n_boundary: int

    def nbytes(self) -> int:
        return (self.lo.nbytes + self.hi.nbytes + self.val.nbytes
                + self.level.nbytes + self.cand.nbytes)

    def validate_partition(self) -> None:
        """Intervals must be sorted, disjoint, and within [0, 4^max_level)."""
        assert np.all(self.lo[1:] > self.lo[:-1])
        assert np.all(self.hi >= self.lo)
        assert np.all(self.hi[:-1] < self.lo[1:])
        assert self.lo[0] >= 0 and self.hi[-1] < (1 << (2 * self.max_level))


def build_cell_covering(census: CensusMap, max_level: int = 9,
                        max_cand: int = 8,
                        min_split_level: int = 2) -> CellCovering:
    """Build the global covering over the census *block* level."""
    assert max_level <= 15, "leaf codes must fit int32"
    x0, x1, y0, y1 = census.extent
    sx, sy = 1.0 / (x1 - x0), 1.0 / (y1 - y0)
    blocks = census.blocks

    # Normalized edge soup of all block polygons.
    verts = blocks.verts.astype(np.float64).copy()
    verts[..., 0] = (verts[..., 0] - x0) * sx
    verts[..., 1] = (verts[..., 1] - y0) * sy
    e1 = verts[:, :-1, :]
    e2 = verts[:, 1:, :]
    # Drop degenerate padding edges.
    keep = ~np.all(e1 == e2, axis=-1)
    poly_of_edge = np.broadcast_to(
        np.arange(blocks.n_poly, dtype=np.int32)[:, None], keep.shape)[keep]
    ex1, ey1 = e1[keep][:, 0], e1[keep][:, 1]
    ex2, ey2 = e2[keep][:, 0], e2[keep][:, 1]

    nbb = blocks.bbox.astype(np.float64).copy()
    nbb[:, 0:2] = (nbb[:, 0:2] - x0) * sx
    nbb[:, 2:4] = (nbb[:, 2:4] - y0) * sy

    rings_n = [verts[p, :blocks.n_verts[p]] for p in range(blocks.n_poly)]

    def center_owner(cx, cy, cand_polys):
        for p in cand_polys:
            if point_in_polygon_host(np.array([cx]), np.array([cy]),
                                     rings_n[p])[0]:
                return int(p)
        return -1

    out_lo, out_hi, out_val, out_lvl = [], [], [], []
    cand_rows: list[np.ndarray] = []

    all_polys = np.arange(blocks.n_poly, dtype=np.int32)
    all_edges = np.arange(len(ex1), dtype=np.int32)
    # BFS stack: (level, ix, iy, candidate polys, candidate edges)
    stack = [(0, 0, 0, all_polys, all_edges)]
    while stack:
        l, ix, iy, cpolys, cedges = stack.pop()
        size = 1.0 / (1 << l)
        rx0, ry0 = ix * size, iy * size
        rx1, ry1 = rx0 + size, ry0 + size
        # Prune candidates to this cell.
        keep_p = ~((nbb[cpolys, 1] < rx0) | (nbb[cpolys, 0] > rx1) |
                   (nbb[cpolys, 3] < ry0) | (nbb[cpolys, 2] > ry1))
        cpolys = cpolys[keep_p]
        if len(cpolys) == 0:
            continue  # outside the map
        hit = _seg_rect_intersect(ex1[cedges], ey1[cedges], ex2[cedges],
                                  ey2[cedges], rx0, rx1, ry0, ry1)
        cedges = cedges[hit]
        shift = 2 * (max_level - l)
        m = int(morton_np(np.array([ix]), np.array([iy]))[0])
        if len(cedges) == 0 and l >= min_split_level:
            owner = center_owner((rx0 + rx1) / 2, (ry0 + ry1) / 2, cpolys)
            if owner < 0:
                continue  # cell fully outside the map
            out_lo.append(m << shift)
            out_hi.append(((m + 1) << shift) - 1)
            out_val.append(owner)
            out_lvl.append(l)
        elif l == max_level:
            # Boundary cell: candidates = polys owning any crossing edge,
            # plus the centre owner (listed first for approximate mode).
            touch = np.unique(poly_of_edge[cedges])
            owner = center_owner((rx0 + rx1) / 2, (ry0 + ry1) / 2, cpolys)
            cands = [owner] if owner >= 0 else []
            cands += [int(p) for p in touch if p != owner]
            cands = cands[:max_cand]
            if not cands:
                continue
            row = np.full(max_cand, -1, np.int32)
            row[:len(cands)] = cands
            out_lo.append(m << shift)
            out_hi.append(((m + 1) << shift) - 1)
            out_val.append(-(len(cand_rows) + 1))
            out_lvl.append(l)
            cand_rows.append(row)
        else:
            for dy in (0, 1):
                for dx in (0, 1):
                    stack.append((l + 1, 2 * ix + dx, 2 * iy + dy,
                                  cpolys, cedges))

    order = np.argsort(np.asarray(out_lo))
    lo = np.asarray(out_lo, np.int32)[order]
    hi = np.asarray(out_hi, np.int32)[order]
    val = np.asarray(out_val, np.int32)[order]
    lvl = np.asarray(out_lvl, np.int8)[order]
    cand = (np.stack(cand_rows) if cand_rows
            else np.zeros((0, max_cand), np.int32))
    cov = CellCovering(lo=lo, hi=hi, val=val, level=lvl, cand=cand,
                       max_level=max_level, extent=census.extent,
                       n_interior=int((val >= 0).sum()),
                       n_boundary=len(cand_rows))
    return cov

"""Host-side quadtree cell covering builder (paper §IV, TPU-adapted).

Builds the *true-hit-filter* index: a non-overlapping hierarchical cell
covering of the census map where each cell either

  * lies fully inside one block polygon  -> interior cell (value = block id),
  * or touches >= 1 polygon boundaries   -> boundary cell (candidate list,
    centre-owner first), emitted only at ``max_level``.

Unlike the paper's per-polygon S2 coverings, we build ONE global covering
top-down (the census map is a partition, so cells never belong to two
interiors).  Each node carries the candidate polygon ids and boundary
edge ids that survive its parent — the build is O(total cells visited), not
O(polygons x cells) — and a whole level of nodes is handled at once, as
arrays of (node, polygon) and (node, edge) pairs.

Cells are identified by Morton (Z-order) codes over a 2^L x 2^L grid in the
map's normalized [0,1)^2 coordinates.  A cell at level l with Morton prefix m
covers leaf codes [m << 2(L-l), (m+1) << 2(L-l)); the index is the sorted
array of these intervals — the TPU-native replacement for the paper's radix
trie (DESIGN.md §2).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.geometry import CensusMap
from repro_torch.obs.profile import span

# The covering level rule (``covering_level``): leaf cells a block, and
# the levels it may pick (leaf codes are int32, so 15 at most).
LEAVES_PER_BLOCK = 64
MIN_LEVEL = 9
MAX_LEVEL = 15
# (node, polygon) + (node, edge) pairs handled at once by the build.
PAIR_CHUNK = 1 << 22


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


def covering_level(n_blocks: int) -> int:
    """The covering depth for a map of ``n_blocks`` blocks: the smallest
    level L >= ``MIN_LEVEL`` with 4^L >= ``LEAVES_PER_BLOCK`` x n_blocks,
    at most ``MAX_LEVEL``.  It keeps the leaf cells a block about
    constant, and with them the share of the map in boundary cells: 9
    up to 4,096 blocks, 10 at 7,888, 12 at the paper's 220,864."""
    level = MIN_LEVEL
    while (level < MAX_LEVEL
           and (1 << (2 * level)) < LEAVES_PER_BLOCK * int(n_blocks)):
        level += 1
    return level


@dataclasses.dataclass
class _EdgeSoup:
    """The block level in the map's normalized [0, 1]^2 frame (float64):
    the non-degenerate ring edges, grouped by polygon in ring order
    (polygon p's are ``[start[p], start[p + 1])``), and each polygon's
    box and its ring's exact y range."""

    x1: np.ndarray
    y1: np.ndarray
    x2: np.ndarray
    y2: np.ndarray
    poly: np.ndarray        # [E] int32 polygon of each edge
    start: np.ndarray       # [P + 1] int64
    bbox: np.ndarray        # [P, 4] (xmin, xmax, ymin, ymax)
    ymin: np.ndarray        # [P] min / max of the normalized ring's y
    ymax: np.ndarray

    @classmethod
    def of(cls, census: CensusMap) -> "_EdgeSoup":
        x0, x1, y0, y1 = census.extent
        sx, sy = 1.0 / (x1 - x0), 1.0 / (y1 - y0)
        blocks = census.blocks
        verts = blocks.verts.astype(np.float64).copy()
        verts[..., 0] = (verts[..., 0] - x0) * sx
        verts[..., 1] = (verts[..., 1] - y0) * sy
        e1 = verts[:, :-1, :]
        e2 = verts[:, 1:, :]
        # Padding edges are zero-length; so is a repeated vertex.  Neither
        # crosses a ray or enters a cell's boundary test.
        keep = ~np.all(e1 == e2, axis=-1)
        poly = np.broadcast_to(
            np.arange(blocks.n_poly, dtype=np.int32)[:, None],
            keep.shape)[keep]
        bbox = blocks.bbox.astype(np.float64).copy()
        bbox[:, 0:2] = (bbox[:, 0:2] - x0) * sx
        bbox[:, 2:4] = (bbox[:, 2:4] - y0) * sy
        start = np.zeros(blocks.n_poly + 1, np.int64)
        np.cumsum(keep.sum(axis=1), out=start[1:])
        return cls(x1=e1[keep][:, 0], y1=e1[keep][:, 1],
                   x2=e2[keep][:, 0], y2=e2[keep][:, 1], poly=poly,
                   start=start, bbox=bbox,
                   ymin=verts[..., 1].min(axis=1),
                   ymax=verts[..., 1].max(axis=1))


def _ranges(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Concatenated ``arange(s, s + n)`` for each (s, n), int64."""
    lens = np.asarray(lens, np.int64)
    total = int(lens.sum())
    ends = np.cumsum(lens)
    return (np.arange(total, dtype=np.int64)
            + np.repeat(np.asarray(starts, np.int64) - (ends - lens), lens))


def _slices(work: np.ndarray, chunk: int):
    """Consecutive (a, b) ranges of items whose ``work`` sums to about
    ``chunk``, at least one item each, covering every item."""
    cum = np.cumsum(work)
    a = 0
    while a < len(work):
        b = int(np.searchsorted(cum, (cum[a - 1] if a else 0) + chunk,
                                side="right"))
        b = min(max(b, a + 1), len(work))
        yield a, b
        a = b


def _segments(node: np.ndarray, n: int):
    """CSR pointers of pairs sorted by ``node`` over ``n`` nodes."""
    ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(node, minlength=n), out=ptr[1:])
    return ptr


def _centre_owner(soup: _EdgeSoup, cx, cy, node, poly,
                  n: int) -> np.ndarray:
    """[n] int32: for each node, the smallest ``poly`` of its (node,
    poly) pairs whose ring holds the node's centre (``cx``, ``cy``), by
    ``point_in_polygon_host``'s fp64 crossing number; -1 where none.

    A ring can hold a point only if the point's y lies in [ymin, ymax)
    of the ring (the half-open straddle rule), so other pairs are
    skipped; each kept pair counts its ring's crossings edge by edge."""
    owner = np.full(n, np.iinfo(np.int32).max, np.int64)
    py = cy[node]
    near = (soup.ymin[poly] <= py) & (py < soup.ymax[poly])
    node, poly = node[near], poly[near]
    n_edge = soup.start[poly + 1] - soup.start[poly]
    for a, b in _slices(n_edge, PAIR_CHUNK):
        nd, pl, ne = node[a:b], poly[a:b], n_edge[a:b]
        e = _ranges(soup.start[pl], ne)
        pair = np.repeat(np.arange(len(nd)), ne)
        px = cx[nd][pair]
        qy = cy[nd][pair]
        x1, y1, x2, y2 = soup.x1[e], soup.y1[e], soup.x2[e], soup.y2[e]
        straddle = (y1 > qy) != (y2 > qy)
        lhs = (px - x1) * (y2 - y1)
        rhs = (qy - y1) * (x2 - x1)
        cross = straddle & ((lhs < rhs) == (y2 > y1))
        inside = np.bincount(pair, weights=cross,
                             minlength=len(nd)).astype(np.int64) % 2 == 1
        np.minimum.at(owner, nd[inside], pl[inside])
    return np.where(owner == np.iinfo(np.int32).max, -1,
                    owner).astype(np.int32)


def build_cell_covering(census: CensusMap, max_level: int | None = None,
                        max_cand: int = 8,
                        min_split_level: int = 2) -> CellCovering:
    """Build the global covering over the census *block* level, one
    level of the quadtree at a time (``max_level`` None: the level
    ``covering_level`` gives the block count).

    Every live node of a level is handled together, as arrays of (node,
    polygon) and (node, edge) pairs that its parent passed down, in
    slices of about ``PAIR_CHUNK`` pairs.  A node keeps the polygons whose
    box meets its closed square and the edges the Liang-Barsky clip
    keeps; one with no polygon left is off the map.  With no edge left
    (and at least ``min_split_level`` deep) it is an interior cell of
    its centre owner, or off the map when no ring holds its centre.  At
    ``max_level`` a node with edges is a boundary cell: its candidates
    are the centre owner, then the other polygons of its edges in
    ascending id, at most ``max_cand``.  Every other node splits in
    four.  Boundary rows are numbered by descending leaf code, the
    order a depth-first walk that visits the last child first reaches
    them.  The arrays equal those of that walk, node by node."""
    if max_level is None:
        max_level = covering_level(census.blocks.n_poly)
    assert max_level <= MAX_LEVEL, "leaf codes must fit int32"
    soup = _EdgeSoup.of(census)
    cells_m, cells_l, cells_v = [], [], []      # interior cells
    bound_m, bound_o, touch_n, touch_p = [], [], [], []
    n_bound = 0
    # The frontier: nodes to visit at ``level``, each with its parent's
    # surviving polygons and edges (CSR over the nodes).
    ix = iy = np.zeros(1, np.int64)
    p_ptr = np.array([0, census.blocks.n_poly], np.int64)
    p_ids = np.arange(census.blocks.n_poly, dtype=np.int32)
    e_ptr = np.array([0, len(soup.x1)], np.int64)
    e_ids = np.arange(len(soup.x1), dtype=np.int32)
    with span("geo.cells.build"):
        for level in range(max_level + 1):
            if len(ix) == 0:
                break
            with span("geo.cells.level"):
                nxt = []
                size = 1.0 / (1 << level)
                work = np.diff(p_ptr) + np.diff(e_ptr)
                for a, b in _slices(work, PAIR_CHUNK):
                    out = _visit(soup, level, size, ix[a:b], iy[a:b],
                                 p_ptr[a:b + 1] - p_ptr[a],
                                 p_ids[p_ptr[a]:p_ptr[b]],
                                 e_ptr[a:b + 1] - e_ptr[a],
                                 e_ids[e_ptr[a]:e_ptr[b]],
                                 max_level, min_split_level)
                    (m, v), (bm, bo, tn, tp), split = out
                    cells_m.append(m)
                    cells_l.append(np.full(len(m), level, np.int8))
                    cells_v.append(v)
                    bound_m.append(bm)
                    bound_o.append(bo)
                    touch_n.append(tn + n_bound)
                    touch_p.append(tp)
                    n_bound += len(bm)
                    nxt.append(split)
                ix, iy, p_ptr, p_ids, e_ptr, e_ids = _concat_frontier(nxt)
        cov = _assemble(cells_m, cells_l, cells_v, bound_m, bound_o,
                        touch_n, touch_p, max_level, max_cand,
                        census.extent)
    return cov


def _visit(soup: _EdgeSoup, level: int, size: float, pix, piy, pp, pids,
           ep, eids, max_level: int, min_split_level: int):
    """One slice of a level's frontier: each node's square at ``level``
    (side ``size``), the polygons and edges its parent passed down
    pruned to it, and the node sorted into an interior cell (leaf-code
    prefix, owner), a boundary cell (prefix, owner, and the (cell,
    polygon) pairs of its edges) or four children (a frontier slice)."""
    n = len(pix)
    rx0, ry0 = pix * size, piy * size
    rx1, ry1 = rx0 + size, ry0 + size
    # Polygons whose box meets the node's closed square.
    node = np.repeat(np.arange(n), np.diff(pp))
    bb = soup.bbox[pids]
    keep = ~((bb[:, 1] < rx0[node]) | (bb[:, 0] > rx1[node])
             | (bb[:, 3] < ry0[node]) | (bb[:, 2] > ry1[node]))
    pn, pids = node[keep], pids[keep]
    n_poly = np.bincount(pn, minlength=n)
    # Edges the clip keeps, on nodes that still hold a polygon.
    node = np.repeat(np.arange(n), np.diff(ep))
    live = n_poly[node] > 0
    en, eids = node[live], eids[live]
    hit = _seg_rect_intersect(soup.x1[eids], soup.y1[eids], soup.x2[eids],
                              soup.y2[eids], rx0[en], rx1[en], ry0[en],
                              ry1[en])
    en, eids = en[hit], eids[hit]
    n_edge = np.bincount(en, minlength=n)

    alive = n_poly > 0
    interior = alive & (n_edge == 0) & (level >= min_split_level)
    boundary = alive & ~interior & (level == max_level)
    split = alive & ~interior & ~boundary
    ask = interior | boundary
    owner = np.full(n, -1, np.int32)
    if ask.any():
        cx, cy = (rx0 + rx1) / 2, (ry0 + ry1) / 2
        sel = ask[pn]
        owner = _centre_owner(soup, cx, cy, pn[sel], pids[sel], n)
    m = morton_np(pix, piy)
    inner = interior & (owner >= 0)
    # Boundary cells: each with the polygons of its edges (unique).
    bidx = np.flatnonzero(boundary)
    slot = np.full(n, -1, np.int64)
    slot[bidx] = np.arange(len(bidx))
    on_b = boundary[en]
    tn, tp = slot[en[on_b]], soup.poly[eids[on_b]]
    n_all = len(soup.bbox)
    pair = np.unique(tn * n_all + tp)
    tn, tp = pair // n_all, (pair % n_all).astype(np.int32)
    # Children: each splitting node's lists passed to its four children,
    # in child order (dy, dx) = (0, 0), (0, 1), (1, 0), (1, 1).
    sidx = np.flatnonzero(split)
    p_lo = _segments(pn, n)
    e_lo = _segments(en, n)
    cnp = np.repeat((p_lo[1:] - p_lo[:-1])[sidx], 4)
    cne = np.repeat((e_lo[1:] - e_lo[:-1])[sidx], 4)
    c_p = pids[_ranges(np.repeat(p_lo[sidx], 4), cnp)]
    c_e = eids[_ranges(np.repeat(e_lo[sidx], 4), cne)]
    dx = np.tile(np.array([0, 1, 0, 1], np.int64), len(sidx))
    dy = np.tile(np.array([0, 0, 1, 1], np.int64), len(sidx))
    cix = 2 * np.repeat(pix[sidx], 4) + dx
    ciy = 2 * np.repeat(piy[sidx], 4) + dy
    frontier = (cix, ciy, cnp, c_p, cne, c_e)
    return ((m[inner], owner[inner]),
            (m[bidx], owner[bidx], tn, tp), frontier)


def _concat_frontier(parts):
    ix = np.concatenate([p[0] for p in parts])
    iy = np.concatenate([p[1] for p in parts])
    p_ptr = np.zeros(len(ix) + 1, np.int64)
    np.cumsum(np.concatenate([p[2] for p in parts]), out=p_ptr[1:])
    e_ptr = np.zeros(len(ix) + 1, np.int64)
    np.cumsum(np.concatenate([p[4] for p in parts]), out=e_ptr[1:])
    return (ix, iy, p_ptr, np.concatenate([p[3] for p in parts]),
            e_ptr, np.concatenate([p[5] for p in parts]))


def _assemble(cells_m, cells_l, cells_v, bound_m, bound_o, touch_n,
              touch_p, max_level, max_cand, extent) -> CellCovering:
    """The covering's arrays from the cells each level emitted: the
    boundary cells' candidate rows (centre owner first, then the other
    touching polygons ascending, cut to ``max_cand``; a cell with none
    is dropped), numbered by descending leaf code, and every cell
    sorted by ``lo``."""
    im = np.concatenate(cells_m)
    il = np.concatenate(cells_l)
    iv = np.concatenate(cells_v).astype(np.int32)
    bm = np.concatenate(bound_m)
    bo = np.concatenate(bound_o)
    tn = np.concatenate(touch_n)
    tp = np.concatenate(touch_p)
    # Candidate lists: the owner (key 0), then the touching polygons
    # other than the owner (key 1) in ascending id.
    other = tp != bo[tn]
    has_o = bo >= 0
    node = np.concatenate([np.flatnonzero(has_o), tn[other]])
    poly = np.concatenate([bo[has_o], tp[other]]).astype(np.int32)
    key = np.concatenate([np.zeros(int(has_o.sum()), np.int8),
                          np.ones(int(other.sum()), np.int8)])
    order = np.lexsort((poly, key, node))
    node, poly = node[order], poly[order]
    ptr = _segments(node, len(bm))
    pos = np.arange(len(node)) - ptr[node]
    kept = np.flatnonzero(np.diff(ptr) > 0)
    # Rows by descending leaf code.
    kept = kept[np.argsort(-bm[kept], kind="stable")]
    row = np.full(len(bm), -1, np.int64)
    row[kept] = np.arange(len(kept))
    cand = np.full((len(kept), max_cand), -1, np.int32)
    fill = pos < max_cand
    cand[row[node[fill]], pos[fill]] = poly[fill]
    m = np.concatenate([im, bm[kept]])
    shift = 2 * (max_level - np.concatenate(
        [il.astype(np.int64), np.full(len(kept), max_level, np.int64)]))
    val = np.concatenate([iv, (-(row[kept] + 1)).astype(np.int32)])
    lvl = np.concatenate([il, np.full(len(kept), max_level, np.int8)])
    lo = m << shift
    hi = ((m + 1) << shift) - 1
    order = np.argsort(lo, kind="stable")
    return CellCovering(lo=lo[order].astype(np.int32),
                        hi=hi[order].astype(np.int32),
                        val=val[order], level=lvl[order].astype(np.int8),
                        cand=cand, max_level=max_level, extent=extent,
                        n_interior=int(len(im)), n_boundary=int(len(kept)))

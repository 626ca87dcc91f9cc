"""Polygon soup geometry for the census-block mapping engine.

Polygons are stored as *closed, padded rings*: ``verts[p, i]`` for
``i in [0, n_verts[p]]`` with ``verts[p, n_verts[p]] == verts[p, 0]``, and all
entries beyond that padded with ``verts[p, 0]``.  Edge ``i`` of polygon ``p``
is ``(verts[p, i], verts[p, i+1])``; padded edges are zero-length and
contribute no ray crossings, so every kernel can run over the full padded
extent without masking.

Device arrays are float32.  The paper stores fp64 because Matlab does; the
crossing-number test only needs consistent orientation comparisons, and the
synthetic data keeps points away from exact boundary contact (see synth.py),
so fp32 is sufficient on device.  Host-side reference checks use fp64 numpy.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

Array = np.ndarray


@dataclasses.dataclass(frozen=True)
class PolygonSoup:
    """A level of the census hierarchy as flat padded arrays (host, numpy).

    Attributes:
      verts:   [n_poly, max_v + 1, 2] float — closed padded rings (see module doc).
      n_verts: [n_poly] int32 — true ring length (excluding the closing vertex).
      bbox:    [n_poly, 4] float — (xmin, xmax, ymin, ymax).
      parent:  [n_poly] int32 — index into the parent level (-1 at top level).
      fips:    [n_poly] int64 — FIPS-style code for the entity.
    """

    verts: Array
    n_verts: Array
    bbox: Array
    parent: Array
    fips: Array

    @property
    def n_poly(self) -> int:
        return int(self.verts.shape[0])

    @property
    def max_v(self) -> int:
        return int(self.verts.shape[1]) - 1

    def edges(self) -> Array:
        """Edge table [n_poly, max_v, 4] = (x1, y1, x2, y2)."""
        a = self.verts[:, :-1, :]
        b = self.verts[:, 1:, :]
        return np.concatenate([a, b], axis=-1)

    def validate(self) -> None:
        n, mv = self.verts.shape[0], self.verts.shape[1] - 1
        assert self.n_verts.shape == (n,)
        assert self.bbox.shape == (n, 4)
        assert self.parent.shape == (n,)
        assert self.fips.shape == (n,)
        assert np.all(self.n_verts >= 3)
        assert np.all(self.n_verts <= mv)
        idx = np.arange(n)
        # Ring closure at position n_verts.
        close = self.verts[idx, self.n_verts, :]
        np.testing.assert_allclose(close, self.verts[:, 0, :], rtol=0, atol=0)
        # bbox consistency.
        assert np.all(self.bbox[:, 0] <= self.bbox[:, 1])
        assert np.all(self.bbox[:, 2] <= self.bbox[:, 3])


def pack_rings(rings: list[np.ndarray], parent: Optional[np.ndarray] = None,
               fips: Optional[np.ndarray] = None,
               max_v: Optional[int] = None,
               dtype=np.float32) -> PolygonSoup:
    """Pack a list of [n_i, 2] open rings into a padded PolygonSoup."""
    n = len(rings)
    nv = np.array([len(r) for r in rings], dtype=np.int32)
    if max_v is None:
        max_v = int(nv.max())
    assert int(nv.max()) <= max_v, (int(nv.max()), max_v)
    verts = np.zeros((n, max_v + 1, 2), dtype=dtype)
    bbox = np.zeros((n, 4), dtype=dtype)
    for i, r in enumerate(rings):
        r = np.asarray(r, dtype=dtype)
        k = len(r)
        verts[i, :k] = r
        verts[i, k:] = r[0]  # close + pad with first vertex
        bbox[i] = (r[:, 0].min(), r[:, 0].max(), r[:, 1].min(), r[:, 1].max())
    if parent is None:
        parent = np.full((n,), -1, dtype=np.int32)
    if fips is None:
        fips = np.arange(n, dtype=np.int64)
    return PolygonSoup(verts=verts, n_verts=nv,
                       bbox=bbox.astype(dtype),
                       parent=parent.astype(np.int32),
                       fips=fips.astype(np.int64))


def polygon_areas(soup: PolygonSoup) -> Array:
    """[n_poly] float64 polygon areas (shoelace over the padded closed
    rings — padding repeats the first vertex, so padded edges contribute
    exactly zero and no masking is needed).  Units are the map's
    coordinate units squared; the analytics layer divides per-block
    occupancy counts by these for crowding density (DESIGN.md §16)."""
    v = soup.verts.astype(np.float64)
    x1, y1 = v[:, :-1, 0], v[:, :-1, 1]
    x2, y2 = v[:, 1:, 0], v[:, 1:, 1]
    return 0.5 * np.abs(np.sum(x1 * y2 - x2 * y1, axis=1))


def point_in_polygon_host(px: Array, py: Array, ring: Array) -> Array:
    """fp64 crossing-number oracle for one polygon (host side, numpy).

    ``ring`` is an open [n, 2] ring (no duplicated closing vertex).
    Returns a bool array matching ``px``/``py``.
    Uses the half-open rule ``(y1 > py) != (y2 > py)`` so vertices on the ray
    are counted exactly once.
    """
    ring = np.asarray(ring, dtype=np.float64)
    px = np.asarray(px, dtype=np.float64)[..., None]
    py = np.asarray(py, dtype=np.float64)[..., None]
    x1, y1 = ring[:, 0], ring[:, 1]
    x2, y2 = np.roll(ring[:, 0], -1), np.roll(ring[:, 1], -1)
    straddle = (y1 > py) != (y2 > py)
    # px < x1 + (py - y1) * (x2 - x1) / (y2 - y1), multiplication-only form.
    lhs = (px - x1) * (y2 - y1)
    rhs = (py - y1) * (x2 - x1)
    cross = straddle & ((lhs < rhs) == (y2 > y1)[None, :])
    return (np.sum(cross, axis=-1) % 2).astype(bool)


@dataclasses.dataclass(frozen=True)
class CensusMap:
    """Three-level hierarchy: states -> counties -> blocks (host container)."""

    states: PolygonSoup
    counties: PolygonSoup
    blocks: PolygonSoup
    # Map extent (xmin, xmax, ymin, ymax) used for cell-code quantization.
    extent: tuple[float, float, float, float]

    def level(self, name: str) -> PolygonSoup:
        return {"state": self.states, "county": self.counties,
                "block": self.blocks}[name]

    def validate(self) -> None:
        for s in (self.states, self.counties, self.blocks):
            s.validate()
        assert np.all(self.counties.parent >= 0)
        assert np.all(self.counties.parent < self.states.n_poly)
        assert np.all(self.blocks.parent >= 0)
        assert np.all(self.blocks.parent < self.counties.n_poly)


def children_tables(level: PolygonSoup, n_parents: int,
                    max_children: Optional[int] = None):
    """Group a level's polygons by parent into dense per-parent tables.

    Returns (child_ids [n_parents, max_children] int32 padded with -1,
             n_children [n_parents] int32).
    """
    order = np.argsort(level.parent, kind="stable")
    counts = np.bincount(level.parent, minlength=n_parents)
    if max_children is None:
        max_children = int(counts.max())
    child_ids = np.full((n_parents, max_children), -1, dtype=np.int32)
    start = 0
    for p in range(n_parents):
        c = counts[p]
        child_ids[p, :c] = order[start:start + c]
        start += c
    return child_ids, counts.astype(np.int32)

"""The port's covering build (``repro_torch.core.cells``) against the
node-at-a-time walk it replaced, and the covering level the port picks.

* ``build_cell_covering`` handles a quadtree level at a time over arrays
  of (node, polygon) and (node, edge) pairs.  ``bfs_covering`` below is
  the walk it replaced, kept as the plain reference: a stack of one node
  at a time.  Equal means bit for bit: ``lo``, ``hi``, ``val``,
  ``level``, ``cand`` (rows numbered as the walk reaches them),
  ``n_interior``, ``n_boundary``.  The JAX package's build is the same
  walk, and the port's build equals it too.
* ``covering_level``: the smallest level >= 9 with 4^L >= 64 x blocks.
  The JAX package always takes 9, so past 4,096 blocks the two differ
  by design (pinned below); an explicit level wins in both.
* At two states (7,888 blocks, level 10) the planner picks ``fast`` and
  its ids equal the benchmark's plain crossing-number reference on
  ``inblock`` points, with nothing past the compaction: at level 9 the
  planner picked ``hybrid`` there and rows came out wrong.
* The build's spans (``geo.cells.build``, one ``geo.cells.level`` a
  level) and the covering's facts in ``memory_footprint()`` and
  ``explain()``.
"""
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro.core.artifact import GeoIndexSet as JIndexSet
from repro.core.cells import build_cell_covering as j_build_covering
from repro.core.engine import EngineConfig as JConfig
from repro_torch.core import cells
from repro_torch.core.artifact import COVERING_KEYS, GeoIndexSet
from repro_torch.core.cells import (CellCovering, _seg_rect_intersect,
                                    build_cell_covering, covering_level,
                                    morton_np)
from repro_torch.core.engine import EngineConfig, GeoEngine
from repro_torch.core.geometry import point_in_polygon_host
from repro_torch.core.synth import build_synth_census

FIELDS = ("lo", "hi", "val", "level", "cand")


def bfs_covering(census, max_level=9, max_cand=8, min_split_level=2):
    """The node-at-a-time walk: a stack of (level, ix, iy, polygons,
    edges), children pushed in Morton order so the last is visited
    first; boundary rows numbered as the walk reaches them."""
    x0, x1, y0, y1 = census.extent
    sx, sy = 1.0 / (x1 - x0), 1.0 / (y1 - y0)
    blocks = census.blocks
    verts = blocks.verts.astype(np.float64).copy()
    verts[..., 0] = (verts[..., 0] - x0) * sx
    verts[..., 1] = (verts[..., 1] - y0) * sy
    e1 = verts[:, :-1, :]
    e2 = verts[:, 1:, :]
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
    cand_rows = []
    stack = [(0, 0, 0, np.arange(blocks.n_poly, dtype=np.int32),
              np.arange(len(ex1), dtype=np.int32))]
    while stack:
        l, ix, iy, cpolys, cedges = stack.pop()
        size = 1.0 / (1 << l)
        rx0, ry0 = ix * size, iy * size
        rx1, ry1 = rx0 + size, ry0 + size
        keep_p = ~((nbb[cpolys, 1] < rx0) | (nbb[cpolys, 0] > rx1) |
                   (nbb[cpolys, 3] < ry0) | (nbb[cpolys, 2] > ry1))
        cpolys = cpolys[keep_p]
        if len(cpolys) == 0:
            continue
        hit = _seg_rect_intersect(ex1[cedges], ey1[cedges], ex2[cedges],
                                  ey2[cedges], rx0, rx1, ry0, ry1)
        cedges = cedges[hit]
        shift = 2 * (max_level - l)
        m = int(morton_np(np.array([ix]), np.array([iy]))[0])
        if len(cedges) == 0 and l >= min_split_level:
            owner = center_owner((rx0 + rx1) / 2, (ry0 + ry1) / 2, cpolys)
            if owner < 0:
                continue
            out_lo.append(m << shift)
            out_hi.append(((m + 1) << shift) - 1)
            out_val.append(owner)
            out_lvl.append(l)
        elif l == max_level:
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
    val = np.asarray(out_val, np.int32)[order]
    return CellCovering(
        lo=np.asarray(out_lo, np.int32)[order],
        hi=np.asarray(out_hi, np.int32)[order], val=val,
        level=np.asarray(out_lvl, np.int8)[order],
        cand=(np.stack(cand_rows) if cand_rows
              else np.zeros((0, max_cand), np.int32)),
        max_level=max_level, extent=census.extent,
        n_interior=int((val >= 0).sum()), n_boundary=len(cand_rows))


def assert_same(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert (a.n_interior, a.n_boundary, a.max_level, a.extent) == \
        (b.n_interior, b.n_boundary, b.max_level, b.extent)


CENSUSES = {
    "small": dict(seed=0, n_states=8, counties_per_state=4,
                  blocks_per_county=16),
    "uneven": dict(seed=1, n_states=3, counties_per_state=5,
                   blocks_per_county=9),
    "few": dict(seed=2, n_states=2, counties_per_state=3,
                blocks_per_county=4),
}


@pytest.fixture(scope="module")
def censuses():
    return {k: build_synth_census(**v).census for k, v in CENSUSES.items()}


@pytest.mark.parametrize("name,level", [("small", 6), ("small", 7),
                                        ("uneven", 7), ("uneven", 8),
                                        ("few", 8), ("few", 9)])
def test_level_synchronous_build_is_the_walk_bit_for_bit(censuses, name,
                                                        level, monkeypatch):
    census = censuses[name]
    want = bfs_covering(census, max_level=level)
    assert want.n_boundary > 0 and want.n_interior > 0
    assert_same(build_cell_covering(census, max_level=level), want)
    # Slices of a few hundred pairs cut every level into many: the same.
    monkeypatch.setattr(cells, "PAIR_CHUNK", 300)
    assert_same(build_cell_covering(census, max_level=level), want)


@pytest.mark.parametrize("level,max_cand,min_split", [(0, 8, 2), (1, 8, 2),
                                                      (5, 2, 2), (6, 8, 4),
                                                      (7, 1, 0)])
def test_edge_settings_are_the_walk_too(censuses, level, max_cand,
                                        min_split):
    """A level below ``min_split_level``, lists cut short by a narrow
    ``max_cand``, a deeper first split and none."""
    census = censuses["uneven"]
    assert_same(build_cell_covering(census, max_level=level,
                                    max_cand=max_cand,
                                    min_split_level=min_split),
                bfs_covering(census, max_level=level, max_cand=max_cand,
                             min_split_level=min_split))


@pytest.mark.parametrize("name,level", [("small", 6), ("few", 7)])
def test_build_is_the_jax_packages(censuses, name, level):
    want = j_build_covering(censuses[name], max_level=level)
    assert_same(build_cell_covering(censuses[name], max_level=level), want)


def _census_of(n_blocks):
    return types.SimpleNamespace(blocks=types.SimpleNamespace(
        n_poly=n_blocks))


@pytest.mark.parametrize("n_blocks,level", [
    (1, 9), (3944, 9), (4096, 9), (4097, 10), (7888, 10), (16384, 10),
    (16385, 11), (220864, 12), (1 << 30, 15)])
def test_level_follows_block_density(n_blocks, level):
    """9 up to 4,096 blocks; 10 at two states (7,888), 12 at the paper's
    220,864; never past 15 (leaf codes are int32)."""
    assert covering_level(n_blocks) == level
    assert GeoIndexSet(census=_census_of(n_blocks)).max_level == level


@pytest.mark.parametrize("n_blocks", [4097, 7888, 220864])
def test_default_level_differs_from_the_jax_package_by_design(n_blocks):
    """The JAX package takes 9 whatever the map; the port follows the
    block count past 4,096 blocks and agrees up to it."""
    assert JIndexSet(census=_census_of(n_blocks)).max_level == 9
    assert JConfig().max_level == 9
    assert GeoIndexSet(census=_census_of(n_blocks)).max_level > 9
    assert GeoIndexSet(census=_census_of(4096)).max_level == 9
    assert EngineConfig().max_level is None


def test_an_explicit_level_wins(censuses):
    census = censuses["few"]
    built = GeoIndexSet.build(census, components=("covering",),
                              max_level=7, device="cpu")
    assert built.max_level == built.covering.max_level == 7
    given = GeoIndexSet(census=census, covering=built.covering)
    assert given.max_level == 7
    eng = GeoEngine.build(census, "fast", EngineConfig(max_level=6),
                          device="cpu")
    assert eng.cfg.max_level == eng.covering.max_level == 6
    eng = GeoEngine.build(census, "fast", device="cpu")
    assert eng.cfg.max_level == eng.covering.max_level == 9


def test_spans_and_covering_facts(censuses):
    census = censuses["small"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        cov = build_cell_covering(census, max_level=7)
    names = [e.name for e in prof.events()]
    assert names.count("geo.cells.build") == 1
    assert names.count("geo.cells.level") == 8        # levels 0..7
    eng = GeoEngine.build(census, "fast", covering=cov, device="cpu")
    facts = eng.explain()["covering"]
    assert set(facts) == set(COVERING_KEYS)
    assert facts == {"covering_level": 7, "covering_cells": len(cov.lo),
                     "covering_boundary_cells": cov.n_boundary,
                     "covering_bytes": cov.nbytes(),
                     "search_iters": eng.fast_index.search_iters}
    assert eng.explain(n_points=1 << 20)["covering"] == facts
    fp = eng.indices.memory_footprint()
    assert {k: fp[k] for k in COVERING_KEYS} == facts
    empty = GeoIndexSet(census=census).memory_footprint()
    assert all(empty[k] == 0 for k in COVERING_KEYS)


def test_two_states_plan_fast_and_map_inblock_exactly():
    """PERF.md's fault at two states: 7,888 blocks, now level 10."""
    from bench import generate, harness
    from bench.reference import census as census_mod
    from bench.reference.crossing import CrossingReference
    census = census_mod.build_census(0, 2, 58, 68)
    idx = GeoIndexSet.build(harness.program_census(census),
                            components=("covering",), device="cpu")
    eng = GeoEngine.from_index_set(idx, "auto", EngineConfig(mode="exact"))
    plan = eng.explain()
    assert eng.strategy == plan["strategy"] == "fast"
    assert plan["covering"]["covering_level"] == 10
    assert plan["boundary_fraction"] < 0.35
    mix = {"pool_batches": 1, "kind": "inblock", "margin": 0.0,
           "band": 3.0}
    pts = generate.make_pool(census, mix, 2**31 + 36, 1 << 14, "cpu")[0]
    res = eng.assign(pts)
    want, n_hits = CrossingReference(census, "cpu").ids(pts)
    assert bool((n_hits == 1).all())
    got = torch.stack([res.state, res.county, res.block], dim=1).int()
    assert torch.equal(got, want)
    assert int(res.stats.overflow) == 0 and int(res.stats.n_need) > 0

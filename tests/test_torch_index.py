"""The port's host map and index build against the JAX package's: the
synthetic census, the cell covering, the FastIndex tensors (the port's
own ``from_covering`` against ``from_numpy`` of the reference's index)
and the quantize / locate helpers.  Tolerance: exact equality (the map
code is a numpy copy; the index holds integers and copied floats).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fast as j_fast
from repro.core.cells import build_cell_covering as j_build_covering
from repro.core.synth import build_synth_census as j_build_census
from repro_torch.core import fast as t_fast
from repro_torch.core.cells import build_cell_covering as t_build_covering
from repro_torch.core.synth import build_synth_census as t_build_census

SOUP_FIELDS = ("verts", "n_verts", "bbox", "parent", "fips")
SMALL = dict(seed=0, n_states=8, counties_per_state=4, blocks_per_county=16)
MID = dict(seed=1, n_states=16, counties_per_state=8, blocks_per_county=24)


@pytest.fixture(scope="module")
def maps(synth_small):
    """Both packages' census and covering (max_level 8) for synth_small."""
    t_sc = t_build_census(**SMALL)
    return {"j": (synth_small, j_build_covering(synth_small.census,
                                                max_level=8)),
            "t": (t_sc, t_build_covering(t_sc.census, max_level=8))}


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("params", [SMALL, MID], ids=["small", "mid"])
def test_census_arrays_equal(params):
    j, t = j_build_census(**params), t_build_census(**params)
    for lvl in ("states", "counties", "blocks"):
        for f in SOUP_FIELDS:
            _eq(getattr(getattr(j.census, lvl), f),
                getattr(getattr(t.census, lvl), f))
    assert j.census.extent == t.census.extent
    for f in ("state_rects", "county_rects", "block_rects"):
        _eq(getattr(j, f), getattr(t, f))
    assert j.sagitta == t.sagitta
    # Same ground-truth stream from the same seed.
    for a, b in zip(j.sample_points(np.random.default_rng(9), 2000),
                    t.sample_points(np.random.default_rng(9), 2000)):
        _eq(a, b)


def test_covering_arrays_equal(maps):
    jc, tc = maps["j"][1], maps["t"][1]
    for f in ("lo", "hi", "val", "level", "cand"):
        _eq(getattr(jc, f), getattr(tc, f))
    assert (jc.max_level, jc.extent, jc.n_interior, jc.n_boundary) == \
        (tc.max_level, tc.extent, tc.n_interior, tc.n_boundary)
    tc.validate_partition()


@pytest.mark.parametrize("gbits", [4, 0])
def test_from_numpy_equals_from_covering(maps, gbits):
    """The reference's index carried across (``from_numpy``) equals the
    port's own build, tensor for tensor, pool included."""
    (jsc, jcov), (tsc, tcov) = maps["j"], maps["t"]
    j = j_fast.FastIndex.from_covering(jcov, jsc.census, gbits=gbits,
                                       with_pool=True)
    arrays = {f: np.asarray(getattr(j, f)) for f in t_fast.INDEX_FIELDS}
    arrays.update({f"edge_pool_{f}": np.asarray(getattr(j.edge_pool, f))
                   for f in t_fast.POOL_FIELDS})
    carried = t_fast.FastIndex.from_numpy(
        arrays, max_level=j.max_level, gbits=j.gbits,
        search_iters=j.search_iters, device="cpu")
    own = t_fast.FastIndex.from_covering(tcov, tsc.census, gbits=gbits,
                                         with_pool=True, device="cpu")
    for f in t_fast.INDEX_FIELDS:
        a, b = getattr(carried, f), getattr(own, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f
        _eq(getattr(j, f), b)
    for f in t_fast.POOL_FIELDS:
        assert torch.equal(getattr(carried.edge_pool, f),
                           getattr(own.edge_pool, f)), f
    for f in ("max_level", "gbits", "search_iters"):
        assert getattr(carried, f) == getattr(own, f) == getattr(j, f)
    assert (own.edge_pool.max_blocks, own.edge_pool.be) == \
        (j.edge_pool.max_blocks, j.edge_pool.be)
    assert own.device == torch.device("cpu")


def _probe_points(sc, n=3000):
    xy = sc.sample_points(np.random.default_rng(11), n)[0]
    x0, x1, y0, y1 = sc.census.extent
    extra = np.array([[x0 - 5.0, y0], [x1 + 1.0, y1], [1e30, 1e30],
                      [x0 - 1.0, y0 - 1.0], [0.0, 1e30], [x0, y0]],
                     np.float32)
    return np.concatenate([xy, extra]).astype(np.float32)


def test_quantize_and_extent_helpers_match(maps):
    sc, cov = maps["j"]
    quant = j_fast.quant_for_extent(cov.extent, cov.max_level)
    _eq(quant, t_fast.quant_for_extent(cov.extent, cov.max_level))
    pts = _probe_points(sc)
    tq = torch.from_numpy(quant)
    tp = torch.from_numpy(pts)
    _eq(j_fast.quantize_codes(jnp.asarray(quant), 8, jnp.asarray(pts)),
        t_fast.quantize_codes(tq, 8, tp))
    _eq(j_fast.extent_mask(jnp.asarray(quant), 8, jnp.asarray(pts)),
        t_fast.extent_mask(tq, 8, tp))
    _eq(j_fast.np_quantize_codes(quant, 8, pts),
        t_fast.np_quantize_codes(quant, 8, pts))
    _eq(j_fast.np_extent_mask(quant, 8, pts),
        t_fast.np_extent_mask(quant, 8, pts))
    # The device codes and the host mirror agree (the serving cache's
    # keys rest on it).
    _eq(t_fast.np_quantize_codes(quant, 8, pts),
        t_fast.quantize_codes(tq, 8, tp))


@pytest.mark.parametrize("gbits", [4, 0])
def test_locate_and_cell_values_match(maps, gbits):
    (jsc, jcov), (tsc, tcov) = maps["j"], maps["t"]
    j = j_fast.FastIndex.from_covering(jcov, jsc.census, gbits=gbits)
    t = t_fast.FastIndex.from_covering(tcov, tsc.census, gbits=gbits,
                                       device="cpu")
    pts = _probe_points(jsc)
    jp, tp = jnp.asarray(pts), torch.from_numpy(pts)
    codes = j_fast.leaf_codes(j, jp)
    _eq(j_fast.locate_cells(j, codes),
        t_fast.locate_cells(t, t_fast.leaf_codes(t, tp)))
    val = t_fast.cell_values(t, tp)
    _eq(j_fast.cell_values(j, jp), val)
    assert (val.numpy()[-6:-1] == t_fast.OUTSIDE).all()
    cid, sid = t_fast.parents_of(t, torch.where(val >= 0, val, -1))
    jcid, jsid = j_fast.parents_of(j, jnp.where(jnp.asarray(val.numpy())
                                                >= 0, val.numpy(), -1))
    _eq(jcid, cid)
    _eq(jsid, sid)


def test_covering_is_a_plain_dataclass_copy(maps):
    """The port's CellCovering carries the same fields, so a covering
    built by either package can seed the other's engine."""
    jc, tc = maps["j"][1], maps["t"][1]
    assert [f.name for f in dataclasses.fields(jc)] == \
        [f.name for f in dataclasses.fields(tc)]

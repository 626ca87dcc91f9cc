"""The port's simple cascade (``repro_torch.core.simple``, on the CPU)
against the JAX package's with ``backend="ref"``: the SimpleIndex
tensors and edge pools, ``from_numpy`` of the reference's index, and
``assign_simple`` ids and per-level stats for default caps, an
overflowing state cap, the fused (edge-pool) path and a single PIP
candidate.  Tolerance: exact equality (ids and counters are integers,
the index holds copied floats).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import simple as j_simple
from repro_torch.core import simple as t_simple

CASES = {
    "default": dict(),
    "capped": dict(cap_state=0.01),
    "fused": dict(fused=True),
    "k1": dict(k_cand=1),
}
POOL_FIELDS = ("blocks", "first", "count")


@pytest.fixture(scope="module")
def indices(synth_small):
    """Both packages' index of synth_small, edge pools included."""
    census = synth_small.census
    return (j_simple.SimpleIndex.from_census(census, with_pools=True),
            t_simple.SimpleIndex.from_census(census, with_pools=True,
                                             device="cpu"))


@pytest.fixture(scope="module")
def points(synth_small, points_small):
    """points_small plus off-extent, FAR and NaN rows."""
    x0, x1, y0, y1 = synth_small.census.extent
    extra = np.array([[x0 - 5.0, y0], [1e30, 1e30], [x1 + 1.0, y1],
                      [0.0, 1e30], [np.nan, y0], [1e30, y0]], np.float32)
    return np.concatenate([points_small[0], extra]).astype(np.float32)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _pools_eq(jp, tp):
    for f in POOL_FIELDS:
        _eq(getattr(jp, f), getattr(tp, f))
    assert (jp.max_blocks, jp.be, jp.n_poly) == \
        (tp.max_blocks, tp.be, tp.n_poly)


def test_index_arrays_equal(indices):
    j, t = indices
    for f in t_simple.INDEX_FIELDS:
        _eq(getattr(j, f), getattr(t, f))
        assert np.asarray(getattr(j, f)).dtype == \
            getattr(t, f).numpy().dtype, f
    for lvl in t_simple.LEVELS:
        _pools_eq(getattr(j, f"{lvl}_pool"), getattr(t, f"{lvl}_pool"))
    # Sentinel rows: an empty box, and a row of -1 children.
    _eq(np.asarray(t_simple.EMPTY_BOX, np.float32), t.block_bbox[-1])
    assert (t.county_children[-1] == -1).all()
    assert (t.block_children[-1] == -1).all()


@pytest.mark.parametrize("with_pools", [True, False])
def test_from_numpy_equals_from_census(synth_small, indices, with_pools):
    """The reference's index carried across equals the port's own
    build, tensor for tensor, pools included."""
    j, own = indices
    arrays = {f: np.asarray(getattr(j, f)) for f in t_simple.INDEX_FIELDS}
    if with_pools:
        for lvl in t_simple.LEVELS:
            arrays.update({f"{lvl}_pool_{f}":
                           np.asarray(getattr(getattr(j, f"{lvl}_pool"), f))
                           for f in POOL_FIELDS})
    carried = t_simple.SimpleIndex.from_numpy(arrays, device="cpu")
    for f in t_simple.INDEX_FIELDS:
        assert torch.equal(getattr(carried, f), getattr(own, f)), f
    for lvl in t_simple.LEVELS:
        pool = getattr(carried, f"{lvl}_pool")
        if with_pools:
            _pools_eq(getattr(j, f"{lvl}_pool"), pool)
        else:
            assert pool is None


@pytest.mark.parametrize("case", list(CASES))
def test_assign_simple_matches_reference(indices, points, points_small,
                                         case):
    """State, county and block ids and every per-level counter equal."""
    j, t = indices
    kw = CASES[case]
    want = j_simple.assign_simple(
        j, jnp.asarray(points), j_simple.SimpleConfig(backend="ref", **kw))
    got = t_simple.assign_simple(t, torch.from_numpy(points),
                                 t_simple.SimpleConfig(**kw))
    for a, b in zip(want[:3], got[:3]):
        _eq(a, b)
    assert set(want[3]) == set(got[3]) == set(t_simple.LEVELS)
    for lvl in t_simple.LEVELS:
        assert {k: int(v) for k, v in want[3][lvl].items()} == \
            {k: int(v) for k, v in got[3][lvl].items()}, lvl
    block = got[2].numpy()
    assert (block[-6:] == -1).all()
    n_real = len(points_small[1])
    if case == "capped":
        assert int(got[3]["state"]["overflow"]) > 0
    elif case != "k1":
        np.testing.assert_array_equal(block[:n_real], points_small[1])
    assert int(got[3]["block"]["n_pip"]) > 0


def test_fused_needs_pools(synth_small, points):
    t = t_simple.SimpleIndex.from_census(synth_small.census, device="cpu")
    with pytest.raises(ValueError, match="with_pools"):
        t_simple.assign_simple(t, torch.from_numpy(points),
                               t_simple.SimpleConfig(fused=True))

"""The edge pool's live-edge counts and the kernels that read them: the
candidate PIP (``crossings_candidates``), which stops at each polygon's
last live edge, and ``crossings_one``, which stages a shared table
without its edges with y1 == y2.

* ``build_edge_pool(...).live`` equals the live-edge count of the dense
  table, and ``EdgePool.from_numpy`` derives the same counts from the
  blocks of a pool packed by ``repro`` (no ``live`` there), at BE 16, 64
  and 256, with a polygon of 0 live edges among them.
* The torch packer (``build_edge_pool``) on the CPU, given an array or a
  tensor, is array-equal to ``repro``'s host packer at BE 16, 64 and
  256: on the census, an empty table, a polygon with no live edge and
  polygons over two or more blocks.  The card-packed pool against the
  CPU-packed one is ``tests/test_torch_onepass_route.py``'s (this file
  imports JAX, which the card's machine lacks).
* The candidate twin with live counts equals ``repro``'s on
  ``backend="ref"`` for every candidate id, -1 and ids past the table
  included, on the census, a random table whose polygons span several
  blocks, and those tables with a polygon emptied.

Tolerance: exact equality throughout (integer counts and masks).  The
cases marked ``cuda`` hold both kernels against their twins on the card
and skip here; chip_smoke.py runs the same on the H100.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro_torch.kernels import gather_pip, ops, pip, ref

NEEDS_CUDA = "needs a CUDA device; chip_smoke.py checks it"
BES = (16, 64, 256)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CUDA)
    return torch.device("cuda")


def _random_table(seed, p=12, e=150):
    """A dense [P, E, 4] table with a third of its rows zero-length
    padding (at random positions) and polygon 3 without a live edge."""
    rng = np.random.default_rng(seed)
    edges = rng.uniform(-1.0, 1.0, (p, e, 4)).astype(np.float32)
    dead = rng.random((p, e)) < 0.3
    dead[3] = True
    edges[dead, 2:] = edges[dead, :2]
    return edges


def _census_table(synth_small, empty=None):
    edges = ops.edges_from_soup_np(synth_small.census.blocks.verts).copy()
    if empty is not None:
        edges[empty] = 0.0
    return edges


def _tables(synth_small):
    return {"census": _census_table(synth_small),
            "census_one_empty": _census_table(synth_small, empty=5),
            "random": _random_table(0)}


def _np_live(edges):
    return (~((edges[..., 0] == edges[..., 2])
              & (edges[..., 1] == edges[..., 3]))).sum(axis=1)


# ------------------------------------------------------- live counts
@pytest.mark.parametrize("be", BES)
@pytest.mark.parametrize("table", ["census", "census_one_empty", "random"])
def test_live_counts(synth_small, table, be):
    edges = _tables(synth_small)[table]
    pool = ops.build_edge_pool(edges, be=be, device="cpu")
    want = _np_live(edges)
    np.testing.assert_array_equal(pool.live.numpy(), want)
    assert pool.live.dtype == torch.int32
    assert (pool.live <= pool.count * be).all()
    if table != "census":
        assert (want == 0).any()
    # A pool packed by the JAX package carries no live counts: from_numpy
    # derives them from its blocks.
    j = j_ops.build_edge_pool(edges, be=be)
    t = ops.EdgePool.from_numpy(j.blocks, j.first, j.count, device="cpu")
    np.testing.assert_array_equal(t.live.numpy(), want)
    assert (t.max_blocks, t.be) == (j.max_blocks, j.be)
    assert t.nbytes() == j.nbytes() + 4 * t.n_poly


def _two_block_table(be):
    """Polygon 0 spans two blocks (BE + 1 live edges, padding between
    them), polygon 1 has no live edge, polygon 2 fills one block."""
    rng = np.random.default_rng(be)
    edges = rng.uniform(-1.0, 1.0, (3, 2 * be + 4, 4)).astype(np.float32)
    edges[0, 1::2, 2:] = edges[0, 1::2, :2]
    edges[0, 2 * be + 2:, 2:] = edges[0, 2 * be + 2:, :2]
    edges[1] = 0.0
    edges[2, be:, 2:] = edges[2, be:, :2]
    return edges


PACK_TABLES = ("census", "census_one_empty", "random", "two_blocks",
               "empty")


@pytest.mark.parametrize("be", BES)
@pytest.mark.parametrize("table", PACK_TABLES)
@pytest.mark.parametrize("given", ["array", "tensor"])
def test_torch_packer_matches_repro(synth_small, table, be, given):
    """The torch packer on the CPU, from a host array or a tensor, is
    array-equal to the JAX package's ``build_edge_pool`` (``blocks``,
    ``first``, ``count``, ``max_blocks``, ``be``), and its ``live`` is
    ``live_from_blocks`` of its own blocks and the dense table's count."""
    edges = {"two_blocks": _two_block_table(be),
             "empty": np.zeros((0, 4, 4), np.float32),
             **(_tables(synth_small) if table not in ("two_blocks", "empty")
                else {})}[table]
    j = j_ops.build_edge_pool(edges, be=be)
    arg = torch.from_numpy(edges.copy()) if given == "tensor" else edges
    t = ops.build_edge_pool(arg, be=be, device="cpu" if given == "array"
                            else None)
    assert t.blocks.device.type == "cpu"
    for f in ("blocks", "first", "count"):
        want, got = np.asarray(getattr(j, f)), getattr(t, f).numpy()
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert (t.max_blocks, t.be) == (j.max_blocks, j.be)
    assert t.live.dtype == torch.int32
    np.testing.assert_array_equal(t.live.numpy(), _np_live(edges))
    np.testing.assert_array_equal(
        t.live.numpy(), gather_pip.live_from_blocks(
            t.blocks.numpy(), t.first.numpy(), t.count.numpy()))
    if table == "two_blocks":
        np.testing.assert_array_equal(t.live.numpy(), [be + 1, 0, be])
        np.testing.assert_array_equal(t.count.numpy(), [2, 0, 1])


def test_live_from_blocks_edge_cases():
    """An empty table, a pool of empty polygons, and a polygon whose
    last live edge fills its last block to the end."""
    for edges in (np.zeros((0, 4, 4), np.float32),
                  np.zeros((3, 5, 4), np.float32)):
        pool = ops.build_edge_pool(edges, be=16, device="cpu")
        live = gather_pip.live_from_blocks(pool.blocks.numpy(),
                                           pool.first.numpy(),
                                           pool.count.numpy())
        np.testing.assert_array_equal(live, pool.live.numpy())
        assert not live.any()
    full = np.random.default_rng(1).uniform(1, 2, (2, 32, 4)).astype(
        np.float32)
    pool = ops.build_edge_pool(full, be=16, device="cpu")
    np.testing.assert_array_equal(pool.live.numpy(), [32, 32])
    np.testing.assert_array_equal(gather_pip.live_from_blocks(
        pool.blocks.numpy(), pool.first.numpy(), pool.count.numpy()),
        [32, 32])


# ------------------------------------------------- twin against repro
def _every_id_rows(synth_small, points_small, n_poly, per_id=24):
    """``per_id`` real points for every id in -1 .. P (P: past the
    table), plus off-extent / FAR / NaN rows with random ids."""
    xy = points_small[0]
    rng = np.random.default_rng(n_poly)
    ids = np.repeat(np.arange(-1, n_poly + 1), per_id)
    pts = xy[rng.integers(0, len(xy), len(ids))]
    x0, _, y0, _ = synth_small.census.extent
    odd = np.array([[x0 - 5.0, y0], [1e30, 1e30], [np.nan, y0],
                    [0.0, np.nan], [np.inf, y0]], np.float32)
    ids = np.concatenate([ids, rng.integers(-1, n_poly, len(odd))])
    return (np.concatenate([pts, odd]).astype(np.float32),
            ids.astype(np.int32))


@pytest.mark.parametrize("be", BES)
@pytest.mark.parametrize("table", ["census", "census_one_empty", "random"])
def test_candidate_twin_matches_repro_for_every_id(synth_small, points_small,
                                                   table, be):
    edges = _tables(synth_small)[table]
    j = j_ops.build_edge_pool(edges, be=be)
    t = ops.build_edge_pool(edges, be=be, device="cpu")
    pts, ids = _every_id_rows(synth_small, points_small, t.n_poly)
    if table == "random":              # points around the random polygons
        pts = np.random.default_rng(be).uniform(
            -1.0, 1.0, pts.shape).astype(np.float32)
    # repro's per-row function on the ids as its ops resolves them.
    safe = np.clip(ids, 0, t.n_poly - 1)
    first = np.where(ids >= 0, np.asarray(j.first)[safe], 0)
    nblk = np.where(ids >= 0, np.asarray(j.count)[safe], 0)
    want = j_ref.crossings_candidates(
        jnp.asarray(pts), jnp.asarray(first, jnp.int32),
        jnp.asarray(nblk, jnp.int32), j.blocks, j.max_blocks)
    got = ref.crossings_candidates(
        torch.from_numpy(ids), torch.from_numpy(pts), t.first, t.count,
        t.live, t.blocks, t.max_blocks)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert np.asarray(want).any()
    np.testing.assert_array_equal(
        np.asarray(j_ops.pip_candidates(jnp.asarray(pts), jnp.asarray(ids),
                                        j, backend="ref")),
        ops.pip_candidates(torch.from_numpy(pts), torch.from_numpy(ids),
                           t).numpy())


def test_live_mask_at_whole_blocks_is_the_unmasked_function(synth_small,
                                                            points_small):
    """``crossings_pool`` with live = count * BE masks nothing: it is
    the reference's per-row function."""
    edges = _random_table(2)
    t = ops.build_edge_pool(edges, be=64, device="cpu")
    pts, ids = _every_id_rows(synth_small, points_small, t.n_poly)
    ids = torch.from_numpy(ids).clamp(0, t.n_poly - 1).long()
    pts = torch.from_numpy(np.random.default_rng(3).uniform(
        -1.0, 1.0, pts.shape).astype(np.float32))
    first, count = t.first[ids], t.count[ids]
    plain = ref.crossings_pool(pts, first, count, t.blocks, t.max_blocks)
    assert torch.equal(plain, ref.crossings_pool(
        pts, first, count, t.blocks, t.max_blocks, live=count * t.be))
    assert torch.equal(plain, ref.crossings_pool(
        pts, first, count, t.blocks, t.max_blocks, live=t.live[ids]))


# ------------------------------------------------------- on the card
def _odd_points(rng, n):
    pts = rng.uniform(-1.0, 1.0, (n, 2)).astype(np.float32)
    extra = [[np.nan, 0.0], [0.0, np.nan], [1e30, 1e30], [-1e30, 0.0],
             [5.0, 5.0], [np.inf, -np.inf], [0.0, -np.inf]]
    return np.concatenate([pts, extra]).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("be", BES)
@pytest.mark.parametrize("source", ["build", "from_numpy"])
def test_cuda_candidates_match_twin(cuda_device, be, source):
    """Multi-block polygons, a polygon with 0 live edges, ids -1 and past
    the table, sorted and unsorted rows, odd points; a pool whose live
    counts were derived from its blocks; a second launch bit-equal."""
    edges = _random_table(be)
    pool = ops.build_edge_pool(edges, be=be, device=cuda_device)
    if source == "from_numpy":
        pool = ops.EdgePool.from_numpy(pool.blocks.cpu().numpy(),
                                       pool.first.cpu().numpy(),
                                       pool.count.cpu().numpy(),
                                       device=cuda_device)
    rng = np.random.default_rng(be)
    pts = torch.as_tensor(_odd_points(rng, 5000), device=cuda_device)
    ids = torch.as_tensor(rng.integers(-1, pool.n_poly + 1, pts.shape[0])
                          .astype(np.int32), device=cuda_device)
    for rows in (ids, torch.sort(ids)[0]):
        args = (rows, pts, pool.first, pool.count, pool.live, pool.blocks,
                pool.max_blocks)
        got = gather_pip.crossings_candidates(*args)
        assert torch.equal(got, ref.crossings_candidates(*args))
        assert torch.equal(got, gather_pip.crossings_candidates(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("n,e", [(5007, 0), (5007, 1), (4096, 256),
                                 (4097, 300), (1, 142), (70000, 37)])
def test_cuda_crossings_one_edge_cases(cuda_device, n, e):
    """E = 0, 1, a tile, not a tile multiple; N not a multiple of the
    block's points; y1 == y2 rows dropped; NaN / inf / far points; a
    second launch bit-equal."""
    rng = np.random.default_rng(n + e)
    pts = torch.as_tensor(_odd_points(rng, n)[-n:], device=cuda_device)
    table = _random_table(e, p=1, e=e)[0] if e else np.zeros((0, 4),
                                                              np.float32)
    if e > 4:
        table[::5, 3] = table[::5, 1]          # horizontal edges
    edges = torch.as_tensor(table, device=cuda_device)
    got = pip.crossings_one(pts, edges)
    assert torch.equal(got, ref.crossings_one(pts, edges))
    assert torch.equal(got, pip.crossings_one(pts, edges))

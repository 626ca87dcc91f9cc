"""The port's kernel layer (src/repro_torch/kernels) against the JAX
package's: each plain PyTorch twin against ``repro.kernels.ref`` on the
same numpy inputs — and the bbox and ``crossings_one`` twins also against
the Pallas kernels themselves, run with ``backend="interpret"`` — the
edge-pool packing, the empty-table normalization and the backend
dispatch.  Tolerance: exact equality throughout (crossing counts, ids,
flags, masks and the packed pool are integers or copied floats).

The CUDA kernels themselves run only on a card: the cases marked
``cuda`` hold each kernel against its twin there and skip elsewhere;
chip_smoke.py checks the same on the main path's inputs.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.cells import build_cell_covering
from repro.core.fast import FastIndex as JFastIndex
from repro.core.resolve import first_k_candidates as j_first_k
from repro.kernels import cascade as j_cascade
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro_torch.core.fast import INDEX_FIELDS, FastIndex
from repro_torch.core.resolve import first_k_candidates
from repro_torch.kernels import bbox, cascade, gather_pip, ops, pip, ref

NEEDS_CUDA = "needs a CUDA device; chip_smoke.py checks it"


@pytest.fixture(scope="module")
def indices(synth_small):
    """The JAX package's index (gbits 4 and 0) over one covering, and the
    port's index carried across from its arrays."""
    census = synth_small.census
    cov = build_cell_covering(census, max_level=8)
    out = {}
    for gbits in (4, 0):
        j = JFastIndex.from_covering(cov, census, gbits=gbits,
                                     with_pool=True)
        out[gbits] = (j, _port_index(j))
    return out


def _port_index(j):
    arrays = {f: np.asarray(getattr(j, f)) for f in INDEX_FIELDS}
    arrays.update({f"edge_pool_{f}": np.asarray(getattr(j.edge_pool, f))
                   for f in ("blocks", "first", "count")})
    return FastIndex.from_numpy(arrays, max_level=j.max_level,
                                gbits=j.gbits,
                                search_iters=j.search_iters, device="cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CUDA)
    return torch.device("cuda")


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.cpu().numpy())


def _edge_points(synth_small, points_small, n=252):
    """Real points plus off-extent, FAR, mixed and NaN rows."""
    xy = points_small[0][:n]
    x0, _, y0, _ = synth_small.census.extent
    extra = [[x0 - 5.0, y0], [1e30, 1e30], [x0 - 1.0, y0 - 1.0],
             [0.0, 1e30], [np.nan, y0], [-1e30, np.inf]]
    return np.concatenate([xy, extra]).astype(np.float32)


def _random_edges(rng, n, e):
    edges = rng.uniform(-1.0, 1.0, (n, e, 4)).astype(np.float32)
    dead = rng.random((n, e)) < 0.3          # zero-length padding edges
    edges[dead, 2:] = edges[dead, :2]
    return edges


# --------------------------------------------------------- scalar helpers
def test_morton_and_effective_iters_match():
    rng = np.random.default_rng(0)
    ix = rng.integers(0, 1 << 15, 1000).astype(np.int32)
    iy = rng.integers(0, 1 << 15, 1000).astype(np.int32)
    _eq(j_cascade.morton(jnp.asarray(ix), jnp.asarray(iy)),
        cascade.morton(torch.from_numpy(ix), torch.from_numpy(iy)))
    assert cascade.OUTSIDE == j_cascade.OUTSIDE
    for n_cells, gbits, iters in ((1, 0, 5), (1000, 0, 3), (31058, 0, 1),
                                  (31058, 4, 7), (10, 2, 0)):
        assert (cascade.effective_iters(n_cells, gbits, iters)
                == j_cascade.effective_iters(n_cells, gbits, iters))


def _random_boxes(rng, shape, empty_frac=0.3):
    """Boxes (xmin, xmax, ymin, ymax) of the given leading shape; a share
    of them are the empty padding box (xmin > xmax)."""
    lo = rng.uniform(-1.0, 1.0, shape + (2,))
    hi = lo + rng.uniform(0.0, 1.0, shape + (2,))
    boxes = np.stack([lo[..., 0], hi[..., 0], lo[..., 1], hi[..., 1]],
                     -1).astype(np.float32)
    boxes[rng.random(shape) < empty_frac] = [1.0, 0.0, 1.0, 0.0]
    return boxes


def _odd_points(rng, n):
    """Random points, then NaN, FAR, off-extent and on-edge rows."""
    pts = rng.uniform(-1.0, 1.0, (n, 2)).astype(np.float32)
    extra = [[np.nan, 0.0], [0.0, np.nan], [1e30, 1e30], [-1e30, 0.0],
             [5.0, 5.0], [-3.0, 0.5], [np.inf, -np.inf]]
    return np.concatenate([pts, extra]).astype(np.float32)


# ----------------------------------------------------------- bbox twins
def test_bbox_mask_twin(synth_small, points_small):
    """The shared-table mask against the Pallas kernel (interpret) and
    the reference oracle: random boxes with empty padding, and the
    census' state boxes."""
    rng = np.random.default_rng(10)
    cases = [(_odd_points(rng, 600), _random_boxes(rng, (37,))),
             (_edge_points(synth_small, points_small),
              np.asarray(synth_small.census.states.bbox, np.float32))]
    for pts, boxes in cases:
        got = ops.bbox_mask(torch.from_numpy(pts), torch.from_numpy(boxes))
        assert got.dtype == torch.int8
        for backend in ("interpret", "ref"):
            _eq(j_ops.bbox_mask(jnp.asarray(pts), jnp.asarray(boxes),
                                backend=backend), got)
        _eq(j_ref.bbox_mask(jnp.asarray(pts), jnp.asarray(boxes)),
            bbox.bbox_mask(torch.from_numpy(pts), torch.from_numpy(boxes)))
        assert 0 < int(got.sum()) < got.numel()
        # NaN / FAR / off-extent rows match no box.
        assert not got[-6:].any()


@pytest.mark.parametrize("c", [1, 8, 24, 40])
def test_bbox_count_select_twin(c):
    """Count and selected slot against the Pallas kernel (interpret) and
    the reference oracle, for one box, the county and block widths, and
    more than one 32-slot ballot chunk."""
    rng = np.random.default_rng(11 + c)
    pts = _odd_points(rng, 700)
    boxes = _random_boxes(rng, (len(pts), c))
    cnt, sel = ops.bbox_count_select(torch.from_numpy(pts),
                                     torch.from_numpy(boxes))
    assert cnt.dtype == sel.dtype == torch.int32
    for backend in ("interpret", "ref"):
        want = j_ops.bbox_count_select(jnp.asarray(pts), jnp.asarray(boxes),
                                       backend=backend)
        _eq(want[0], cnt)
        _eq(want[1], sel)
    for a, b in zip(j_ref.bbox_count_select(jnp.asarray(pts),
                                            jnp.asarray(boxes)),
                    bbox.bbox_count_select(torch.from_numpy(pts),
                                           torch.from_numpy(boxes))):
        _eq(a, b)
    assert (cnt[-7:] == 0).all() and (sel[-7:] == -1).all()
    assert int(cnt.max()) > (1 if c > 1 else 0)
    if c == 40:
        assert int(sel.max()) >= 32          # a hit in the second chunk
    # The gathered mask (a torch op on every backend) agrees.
    _eq(j_ops.bbox_mask_gathered(jnp.asarray(pts), jnp.asarray(boxes),
                                 backend="ref"),
        ops.bbox_mask_gathered(torch.from_numpy(pts),
                               torch.from_numpy(boxes)))


@pytest.mark.parametrize("source", ["random", "census", "empty"])
def test_crossings_one_twin(synth_small, points_small, source):
    """Crossings against one shared table: the twin against the Pallas
    kernel (interpret, through ``pip_one``) and the reference oracle."""
    rng = np.random.default_rng(12)
    if source == "random":
        pts = _odd_points(rng, 600)
        edges = _random_edges(rng, 1, 300)[0]
    elif source == "census":
        pts = _edge_points(synth_small, points_small)
        edges = ops.edges_from_soup_np(synth_small.census.states.verts)[3]
    else:
        pts = _odd_points(rng, 50)
        edges = np.zeros((0, 4), np.float32)
    tp, te = torch.from_numpy(pts), torch.from_numpy(edges)
    cross = pip.crossings_one(tp, te)
    _eq(j_ref.crossings_one(jnp.asarray(pts), jnp.asarray(edges)), cross)
    _eq(j_ref.crossings_one(jnp.asarray(pts), jnp.asarray(edges)),
        ref.crossings_one(tp, te))
    inside = ops.pip_one(tp, te)
    # The Pallas grid cannot take an empty table (it pads E to 512 but
    # slices 512 of 0), so E = 0 is held against the oracle alone.
    for backend in ("interpret", "ref") if len(edges) else ("ref",):
        _eq(j_ops.pip_one(jnp.asarray(pts), jnp.asarray(edges),
                          backend=backend), inside)
    if source == "empty":
        assert not cross.any()
    else:
        assert inside.any() and not inside.all()


@pytest.mark.parametrize("k", [1, 3, 4, 30])
@pytest.mark.parametrize("c", [1, 8, 24])
def test_first_k_candidates_matches_reference(k, c):
    """Slots of the first min(k, C) set bits, -1 past them: k > C, rows
    with fewer than k set bits, empty and full rows."""
    rng = np.random.default_rng(13)
    mask = (rng.random((300, c)) < rng.random((300, 1))).astype(np.int8)
    mask[0] = 0
    mask[1] = 1
    want = j_first_k(jnp.asarray(mask), k)
    got = first_k_candidates(torch.from_numpy(mask), k)
    assert got.shape == (300, min(k, c))
    _eq(want, got)
    assert (got[0] == -1).all()
    assert (got[1] == torch.arange(min(k, c))).all()


# ----------------------------------------------------------- edge pool
@pytest.mark.parametrize("be", [128, 256])
@pytest.mark.parametrize("table", ["census", "random", "empty"])
def test_build_edge_pool_array_equal(synth_small, table, be):
    if table == "census":
        edges = j_ops.edges_from_soup_np(synth_small.census.blocks.verts)
        np.testing.assert_array_equal(
            edges, ops.edges_from_soup_np(synth_small.census.blocks.verts))
    elif table == "random":
        edges = _random_edges(np.random.default_rng(1), 40, 300)
    else:
        edges = np.zeros((0, 12, 4), np.float32)
    j = j_ops.build_edge_pool(edges, be=be)
    t = ops.build_edge_pool(edges, be=be, device="cpu")
    for f in ("blocks", "first", "count"):
        _eq(getattr(j, f), getattr(t, f))
    assert (t.max_blocks, t.be, t.n_poly) == (j.max_blocks, j.be, j.n_poly)
    # The port's pool also holds ``live`` [P] i32.
    assert t.nbytes() == j.nbytes() + 4 * t.n_poly


# ------------------------------------------------------ crossing twins
@pytest.mark.parametrize("source", ["random", "census"])
def test_crossings_gathered_twin(synth_small, points_small, source):
    rng = np.random.default_rng(2)
    if source == "random":
        pts = rng.uniform(-1.0, 1.0, (500, 2)).astype(np.float32)
        edges = _random_edges(rng, 500, 37)
    else:
        pts = _edge_points(synth_small, points_small)
        table = ops.edges_from_soup_np(synth_small.census.blocks.verts)
        edges = table[rng.integers(0, len(table), len(pts))]
    want = j_ref.crossings_gathered(jnp.asarray(pts), jnp.asarray(edges))
    got = ref.crossings_gathered(torch.from_numpy(pts),
                                 torch.from_numpy(edges))
    _eq(want, got)
    # The wrapper takes the twin for CPU tensors.
    _eq(want, pip.crossings_gathered(torch.from_numpy(pts),
                                     torch.from_numpy(edges)))
    assert np.asarray(want).sum() > 0


def test_crossings_candidates_twin(indices, synth_small, points_small):
    """The reference's per-row function (block ranges resolved from ids)
    against the port's: ``crossings_pool`` on the same ranges, and the
    id-taking twin and wrapper, which stop at each polygon's live
    count."""
    j, t = indices[4]
    pts = _edge_points(synth_small, points_small)
    rng = np.random.default_rng(3)
    pids = rng.integers(-1, t.edge_pool.n_poly, len(pts)).astype(np.int32)
    pool = t.edge_pool
    safe = np.clip(pids, 0, None)
    first = np.where(pids >= 0, pool.first.numpy()[safe], 0).astype(np.int32)
    nblk = np.where(pids >= 0, pool.count.numpy()[safe], 0).astype(np.int32)
    want = j_ref.crossings_candidates(
        jnp.asarray(pts), jnp.asarray(first), jnp.asarray(nblk),
        j.edge_pool.blocks, j.edge_pool.max_blocks)
    got = ref.crossings_pool(
        torch.from_numpy(pts), torch.from_numpy(first),
        torch.from_numpy(nblk), pool.blocks, pool.max_blocks)
    _eq(want, got)
    args = (torch.from_numpy(pids), torch.from_numpy(pts), pool.first,
            pool.count, pool.live, pool.blocks, pool.max_blocks)
    _eq(want, ref.crossings_candidates(*args))
    _eq(want, gather_pip.crossings_candidates(*args))


def test_ops_pip_masks_match(indices, synth_small, points_small):
    """ops.pip_candidates / ops.pip_gathered (id < 0 never inside)."""
    j, t = indices[4]
    pts = _edge_points(synth_small, points_small)
    rng = np.random.default_rng(4)
    pids = rng.integers(-1, t.edge_pool.n_poly, len(pts)).astype(np.int32)
    _eq(j_ops.pip_candidates(jnp.asarray(pts), jnp.asarray(pids),
                             j.edge_pool, backend="ref"),
        ops.pip_candidates(torch.from_numpy(pts), torch.from_numpy(pids),
                           t.edge_pool))
    edges = np.asarray(j.block_edges)[np.clip(pids, 0, None)]
    _eq(j_ops.pip_gathered(jnp.asarray(pts), jnp.asarray(edges),
                           backend="ref"),
        ops.pip_gathered(torch.from_numpy(pts), torch.from_numpy(edges)))


# ------------------------------------------------------ one-pass cascade
def _cascade_both(j, t, pts, backend="ref", **over):
    jargs = [getattr(j, f) for f in ("quant", "cell_lo", "cell_hi",
                                     "cell_val", "top_start", "cand",
                                     "block_bbox")]
    targs = [getattr(t, f) for f in ("quant", "cell_lo", "cell_hi",
                                     "cell_val", "top_start", "cand",
                                     "block_bbox")]
    jpool, tpool = j.edge_pool, t.edge_pool
    if over.get("empty_cand"):
        jargs[5] = jnp.zeros((0, 8), jnp.int32)
        targs[5] = torch.zeros((0, 8), dtype=torch.int32)
    if over.get("empty_cells"):
        for a in (1, 2, 3):
            jargs[a] = jnp.zeros((0,), jnp.int32)
            targs[a] = torch.zeros(0, dtype=torch.int32)
    if over.get("empty_pool"):
        jpool = j_ops.build_edge_pool(np.zeros((0, 4, 4), np.float32))
        tpool = ops.build_edge_pool(np.zeros((0, 4, 4), np.float32),
                                    device="cpu")
    kw = dict(max_level=j.max_level, gbits=j.gbits,
              search_iters=j.search_iters)
    want = j_ops.assign_cascade(jnp.asarray(pts), *jargs, jpool, **kw,
                                backend="ref")
    got = ops.assign_cascade(torch.as_tensor(pts, device=t.device),
                             *targs, tpool, **kw, backend=backend)
    return want, got


@pytest.mark.parametrize("gbits", [4, 0])
def test_assign_cascade_twin(indices, synth_small, points_small, gbits):
    """All four outputs equal, on real points plus off-extent / FAR / NaN
    rows, for a top-grid index and a gbits=0 (full-search) one."""
    j, t = indices[gbits]
    pts = _edge_points(synth_small, points_small)
    want, got = _cascade_both(j, t, pts)
    for a, b in zip(want, got):
        _eq(a, b)
    flags = got[1].numpy()
    assert (flags & 1).sum() > 0          # the boundary path ran
    tail = slice(len(pts) - 6, None)      # off-extent rows: -1, no flags
    assert (got[0].numpy()[tail] == -1).all()
    for out in got[1:]:
        assert (out.numpy()[tail] == 0).all()


@pytest.mark.parametrize("empty", ["empty_cand", "empty_cells",
                                   "empty_pool"])
def test_assign_cascade_empty_tables(indices, synth_small, points_small,
                                     empty):
    j, t = indices[4]
    pts = _edge_points(synth_small, points_small, n=64)
    want, got = _cascade_both(j, t, pts, **{empty: True})
    for a, b in zip(want, got):
        _eq(a, b)


# ------------------------------------------------------------- dispatch
def test_resolve_backend(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_KERNELS", raising=False)
    assert ops.resolve_backend(None, "cpu") == "ref"
    assert ops.resolve_backend("auto", torch.device("cpu")) == "ref"
    with pytest.raises(ValueError, match="cannot run"):
        ops.resolve_backend("cuda", "cpu")
    with pytest.raises(ValueError, match="cannot run"):
        ops.resolve_backend("ref", "cuda")
    with pytest.raises(ValueError, match="unknown kernel backend"):
        ops.resolve_backend("pallas", "cpu")
    monkeypatch.setenv("REPRO_TORCH_KERNELS", "cuda")
    with pytest.raises(ValueError, match="cannot run"):
        ops.pip_gathered(torch.zeros(1, 2), torch.zeros(1, 3, 4))
    pts, boxes = torch.zeros(1, 2), torch.zeros(1, 3, 4)
    for call in (lambda: ops.pip_one(pts, torch.zeros(3, 4)),
                 lambda: ops.bbox_mask(pts, boxes[0]),
                 lambda: ops.bbox_count_select(pts, boxes),
                 # No kernel behind it, but the backend is still checked.
                 lambda: ops.bbox_mask_gathered(pts, boxes)):
        with pytest.raises(ValueError, match="cannot run"):
            call()


# ------------------------------------------- CUDA kernels vs their twins
def _cascade_batch(t, synth_small, points_small, batch):
    """Points for the cascade: the edge rows of ``_edge_points``, or
    (classified by the twin on the CPU) only boundary-cell points, only
    interior ones, or a ragged batch (no multiple of the kernel's 256-point
    blocks) with off-extent, FAR and NaN rows mixed in."""
    pts = _edge_points(synth_small, points_small)
    if batch == "edge_points":
        return pts
    args = [getattr(t, f) for f in ("quant", "cell_lo", "cell_hi",
                                     "cell_val", "top_start", "cand",
                                     "block_bbox")]
    pool = t.edge_pool
    xy = points_small[0].astype(np.float32)
    _, flags, _, _ = ref.assign_cascade(
        torch.as_tensor(xy), *args, pool.first, pool.count, pool.blocks,
        max_blocks=pool.max_blocks, max_level=t.max_level, gbits=t.gbits,
        search_iters=t.search_iters)
    bnd = (flags.numpy() & 1) == 1
    if batch == "boundary":
        return xy[bnd]
    if batch == "interior":
        return xy[~bnd]
    rng = np.random.default_rng(3)
    out = xy[rng.permutation(len(xy))[:1037]].copy()
    odd = pts[-6:]
    at = rng.choice(len(out), 60, replace=False)
    out[at] = odd[np.arange(60) % len(odd)]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("batch", ["edge_points", "boundary", "interior",
                                   "ragged"])
def test_cuda_assign_cascade_matches_twin(indices, synth_small,
                                          points_small, cuda_device, batch):
    """The kernel bit-equal to its twin on real points with off-extent /
    FAR / NaN rows, on boundary-cell points only (every point through the
    queue and the edge tests), on interior points only (none), and on a
    ragged batch with odd rows mixed in."""
    _, t = indices[4]
    tc = dataclasses.replace(
        t, **{f: getattr(t, f).to(cuda_device) for f in INDEX_FIELDS},
        edge_pool=dataclasses.replace(
            t.edge_pool, blocks=t.edge_pool.blocks.to(cuda_device),
            first=t.edge_pool.first.to(cuda_device),
            count=t.edge_pool.count.to(cuda_device)))
    pts = _cascade_batch(t, synth_small, points_small, batch)
    args = [getattr(tc, f) for f in ("quant", "cell_lo", "cell_hi",
                                     "cell_val", "top_start", "cand",
                                     "block_bbox")]
    pool = tc.edge_pool
    kw = dict(max_level=t.max_level, gbits=t.gbits,
              search_iters=t.search_iters)
    p = torch.as_tensor(pts, device=cuda_device)
    got = cascade.assign_cascade(p, *args, pool.first, pool.count,
                                 pool.blocks, **kw)
    want = ref.assign_cascade(p, *args, pool.first, pool.count,
                              pool.blocks, max_blocks=pool.max_blocks, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    boundary = (got[1] & 1).bool()
    if batch == "boundary":
        assert bool(boundary.all())
    elif batch == "interior":
        assert not bool(boundary.any())


@pytest.mark.parametrize("batch", ["boundary", "interior", "ragged"])
def test_assign_cascade_twin_on_kernel_test_batches(indices, synth_small,
                                                    points_small, batch):
    """The CUDA test's batches through the twin, equal to repro's: the
    boundary batch is all boundary-cell hits, the interior batch none,
    and the ragged one no multiple of the kernel's 256-point blocks, its
    off-extent / FAR / NaN rows unassigned."""
    j, t = indices[4]
    pts = _cascade_batch(t, synth_small, points_small, batch)
    want, got = _cascade_both(j, t, pts)
    for a, b in zip(want, got):
        _eq(a, b)
    bid, flags = got[0].numpy(), got[1].numpy()
    assert len(pts) > 0
    if batch == "boundary":
        assert ((flags & 1) == 1).all()
    elif batch == "interior":
        assert ((flags & 1) == 0).all()
    else:
        odd = ~np.isfinite(pts).all(1) | (np.abs(pts) > 1e29).any(1)
        assert len(pts) % 256 != 0 and odd.sum() > 0
        assert (bid[odd] == -1).all() and (flags[odd] == 0).all()


@pytest.mark.cuda
def test_cuda_crossing_kernels_match_twins(cuda_device):
    rng = np.random.default_rng(5)
    pts = torch.as_tensor(rng.uniform(-1, 1, (4099, 2)).astype(np.float32),
                          device=cuda_device)
    edges = torch.as_tensor(_random_edges(rng, 4099, 37),
                            device=cuda_device)
    assert torch.equal(pip.crossings_gathered(pts, edges),
                       ref.crossings_gathered(pts, edges))
    pool = ops.build_edge_pool(_random_edges(rng, 50, 600), be=128,
                               device=cuda_device)
    pids = torch.as_tensor(rng.integers(-1, 50, 4099).astype(np.int32),
                           device=cuda_device)
    args = (pids, pts, pool.first, pool.count, pool.live, pool.blocks,
            pool.max_blocks)
    assert torch.equal(gather_pip.crossings_candidates(*args),
                       ref.crossings_candidates(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 8, 24, 40])
def test_cuda_bbox_kernels_match_twins(cuda_device, c):
    rng = np.random.default_rng(14)
    pts = torch.as_tensor(_odd_points(rng, 5000), device=cuda_device)
    boxes = torch.as_tensor(_random_boxes(rng, (pts.shape[0], c)),
                            device=cuda_device)
    for a, b in zip(bbox.bbox_count_select(pts, boxes),
                    ref.bbox_count_select(pts, boxes)):
        assert torch.equal(a, b)
    shared = boxes[0].contiguous()
    assert torch.equal(bbox.bbox_mask(pts, shared),
                       ref.bbox_mask(pts, shared))


@pytest.mark.cuda
@pytest.mark.parametrize("e", [0, 37, 300])
def test_cuda_crossings_one_matches_twin(cuda_device, e):
    rng = np.random.default_rng(15)
    pts = torch.as_tensor(_odd_points(rng, 5000), device=cuda_device)
    edges = torch.as_tensor(_random_edges(rng, 1, e)[0]
                            .reshape(e, 4), device=cuda_device)
    assert torch.equal(pip.crossings_one(pts, edges),
                       ref.crossings_one(pts, edges))


# ------------------------- the redesigned bbox_mask kernel's shapes
# Box counts in both of the kernel's layouts (flat: a super-row of
# M / gcd(M, 16) 16-byte chunks fits the 256 threads; box tiles: 513, odd
# and over 256) and point counts that are no multiple of anything.
BBOX_BOXES = (1, 7, 16, 33, 56, 513, 3072)
BBOX_ROWS = (0, 1, 1027)


def _bbox_case(m, n):
    """Seeded boxes (one in five empty), and n points: random ones with
    NaN / inf / FAR rows and rows exactly on a box's xmin or ymax."""
    rng = np.random.default_rng(m * 7 + n)
    boxes = _random_boxes(rng, (m,), empty_frac=0.2)
    pts = _odd_points(rng, max(n, 8))
    k = np.arange(len(pts)) % m
    pts[::13, 0] = boxes[k[::13], 0]
    pts[5::17, 1] = boxes[k[5::17], 3]
    return pts[-n:] if n else pts[:0], boxes


def _plus8(t):
    """``t`` ([n, 2] f32) as a view that starts 8 bytes into a buffer."""
    buf = torch.empty(2 * t.shape[0] + 2, dtype=t.dtype, device=t.device)
    buf[2:] = t.reshape(-1)
    return buf[2:].view(-1, 2)


@pytest.mark.parametrize("n", BBOX_ROWS)
@pytest.mark.parametrize("m", BBOX_BOXES)
def test_bbox_mask_twin_at_kernel_shapes(m, n):
    """The wrapper (the twin on the CPU) against the reference oracle at
    the kernel's shapes, on aligned points and on a view 8 bytes into a
    buffer; NaN / inf / FAR rows match no box."""
    pts, boxes = _bbox_case(m, n)
    want = j_ref.bbox_mask(jnp.asarray(pts), jnp.asarray(boxes))
    t_pts, t_boxes = torch.from_numpy(pts), torch.from_numpy(boxes)
    for p in (t_pts, _plus8(t_pts)):
        got = bbox.bbox_mask(p, t_boxes)
        assert got.dtype == torch.int8 and got.shape == (n, m)
        _eq(want, got)
    bad = ~np.isfinite(pts).all(1) | (np.abs(pts) > 1e29).any(1)
    assert not np.asarray(want)[bad].any()


@pytest.mark.cuda
@pytest.mark.parametrize("n", BBOX_ROWS + ((1 << 16) + 3,))
@pytest.mark.parametrize("m", BBOX_BOXES)
def test_cuda_bbox_mask_kernel_shapes(cuda_device, m, n):
    """On the card: bit-equal to the twin at each shape, on aligned points
    and on a view 8 bytes into a buffer; a second launch bit-equal; one
    launch a call."""
    from repro_torch.kernels import _build
    pts, boxes = _bbox_case(m, n)
    t_boxes = torch.from_numpy(boxes).to(cuda_device)
    t_pts = torch.from_numpy(pts).to(cuda_device)
    for p in (t_pts, _plus8(t_pts)):
        _build.reset_launches()
        got = bbox.bbox_mask(p, t_boxes)
        assert _build.LAUNCHES["bbox_mask"] == (1 if n else 0)
        assert torch.equal(got, bbox.bbox_mask(p, t_boxes))
        assert torch.equal(got, ref.bbox_mask(p, t_boxes))


def test_check_counts_each_launch(monkeypatch):
    """``_build.check`` adds a call's launches to its kernel's count (two
    for the segment kernel with a value column) and nothing on a failed
    launch."""
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "LAUNCHES", dict(_build.LAUNCHES))
    _build.reset_launches()
    _build.check(0, "segment_reduce_sorted", launches=2)
    _build.check(0, "bbox_mask")
    assert _build.LAUNCHES["segment_reduce_sorted"] == 2
    assert _build.LAUNCHES["bbox_mask"] == 1
    monkeypatch.setattr(_build, "load", lambda: type(
        "Lib", (), {"repro_cuda_error_string": staticmethod(
            lambda status: b"invalid argument")})())
    with pytest.raises(RuntimeError, match="invalid argument"):
        _build.check(1, "bbox_mask")
    assert _build.LAUNCHES["bbox_mask"] == 1

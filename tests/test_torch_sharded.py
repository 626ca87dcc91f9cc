"""The port's Morton-sharded geo lookup (``repro_torch.core.distributed``,
the ``sharded`` strategy, ``GeoEngine.assign_sharded``,
``launch.mesh.Mesh``) against the JAX package's with ``backend="ref"``,
on the CPU.

* ``shard_covering`` at 1, 2, 4 and 8 shards: every array equal to
  ``repro``'s (padding, re-based candidate rows, ``range_lo``, the pool),
  and ``index_bytes_per_shard()``.
* In process, on a (1, 1) mesh (no process group): ``assign_sharded``
  (exact, exact fused, approx, a capacity that drops, one Morton range)
  and ``assign_fast_distributed`` give ``repro``'s ids and ``GeoStats``
  (``extra`` included); off-extent points come back -1.
* Multi-rank: ``repro`` on 8 fake devices in one child interpreter,
  jitted, on meshes (1, 4) and (2, 4), beside the port on one spawn of 4
  and one of 8 gloo CPU ranks (rendezvous through a file); every rank's
  ids and stats equal ``repro``'s, including a batch that leaves three
  shards empty (every rank still joins every collective) and one whose
  drops are exactly the points past their shard's capacity.
* Errors and capabilities as ``repro``'s.

Tolerance: exact equality.  The multi-rank fixture runs once per module
(~30-40 s); each spawn and the JAX child have their own time limits, so
a rank stuck in a collective fails the fixture instead of hanging.
"""
import dataclasses
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sharded_pair
from repro.core.artifact import GeoIndexSet as JIndexSet
from repro.core.cells import build_cell_covering
from repro.core.distributed import assign_fast_distributed as j_afd
from repro.core.distributed import shard_covering as j_shard
from repro.core.engine import EngineConfig as JConfig
from repro.core.engine import GeoEngine as JEngine
from repro.core.fast import FastConfig as JFastConfig
from repro.core.registry import sharded_strategies as j_sharded_strategies
from repro.launch.mesh import make_test_mesh as j_mesh
from repro_torch.core import registry as t_registry
from repro_torch.core.cells import CellCovering
from repro_torch.core.compact import capacity_for
from repro_torch.core.distributed import (assign_fast_distributed,
                                          shard_covering)
from repro_torch.core.engine import EngineConfig, GeoEngine
from repro_torch.core.fast import FastConfig, np_quantize_codes
from repro_torch.launch.mesh import Mesh, make_test_mesh
from sharded_pair import (BASE, DIST_CAP, DIST_CASES, MESHES, SHARDED_CASES,
                          mesh_tag, record)
from subproc import run_py

ALL_CASES = list(SHARDED_CASES) + list(DIST_CASES)
SKEW_SHARD, RANGE_SHARD = 0, 1
JAX_TIMEOUT_S = 600
SPAWN_TIMEOUT_S = {4: 300, 8: 360}


@pytest.fixture(scope="module")
def covering(synth_small):
    return build_cell_covering(synth_small.census, max_level=8)


@pytest.fixture(scope="module")
def t_cov(covering):
    return CellCovering(**dataclasses.asdict(covering))


def _far_points(census, n: int = 8) -> np.ndarray:
    """tests/test_engine.py's off-extent points."""
    x0, x1, y0, y1 = census.extent
    w, h = x1 - x0, y1 - y0
    base = np.array([[x1 + w, (y0 + y1) / 2], [x0 - 2 * w, y0 - h],
                     [(x0 + x1) / 2, y1 + 0.5 * h],
                     [x0 - 0.01 * w, (y0 + y1) / 2]], np.float32)
    return np.tile(base, (n // len(base) + 1, 1))[:n]


def _owners(sidx, xy) -> np.ndarray:
    """Each point's Morton shard, on the host."""
    codes = np_quantize_codes(sidx.quant.numpy(), sidx.max_level, xy)
    return np.clip(np.searchsorted(sidx.range_lo.numpy(), codes,
                                   side="right") - 1, 0, sidx.n_shards - 1)


@pytest.fixture(scope="module")
def batches(synth_small, points_small, t_cov):
    """points: points_small plus 8 off-extent rows; skewed: 3/4 of the
    rows in Morton shard SKEW_SHARD of 4; one_range: every row in shard
    RANGE_SHARD of 4."""
    xy = points_small[0]
    owner = _owners(shard_covering(t_cov, synth_small.census, 4,
                                   device="cpu"), xy)
    rng = np.random.default_rng(5)
    n = len(xy)
    skew = np.concatenate([
        rng.choice(np.flatnonzero(owner == SKEW_SHARD), 3 * n // 4),
        rng.choice(np.flatnonzero(owner != SKEW_SHARD), n // 4)])
    rng.shuffle(skew)
    one = rng.choice(np.flatnonzero(owner == RANGE_SHARD), n)
    return {"points": np.concatenate([xy, _far_points(
                synth_small.census)]).astype(np.float32),
            "skewed": xy[skew], "one_range": xy[one]}


@pytest.fixture(scope="module")
def multi(synth_small, covering, batches, tmp_path_factory):
    """The JAX child's results and each gloo world's per-rank results:
    {"jax": {...}, 4: [rank dicts], 8: [rank dicts]}."""
    root = tmp_path_factory.mktemp("sharded")
    artifact = str(root / "artifact")
    JIndexSet(census=synth_small.census, covering=covering,
              max_level=8).save(artifact)
    data = str(root / "batches.npz")
    np.savez(data, **batches)
    jax_out = str(root / "jax.npz")
    code = ("import sys; sys.path.insert(0, 'tests'); import sharded_pair; "
            f"sharded_pair.jax_reference({artifact!r}, {data!r}, "
            f"{jax_out!r})")
    child = []
    t = threading.Thread(target=lambda: child.append(run_py(
        code, extra_env={"XLA_FLAGS": sharded_pair.XLA_FLAGS,
                         "JAX_PLATFORMS": "cpu"}, timeout=JAX_TIMEOUT_S)))
    t.start()
    out = {}
    try:
        for world in MESHES:
            ranks_dir = root / f"ranks{world}"
            ranks_dir.mkdir()
            sharded_pair.spawn_ranks(
                world, (str(root / f"rendezvous{world}"), artifact, data,
                        str(ranks_dir)), SPAWN_TIMEOUT_S[world])
            out[world] = [dict(np.load(ranks_dir / f"rank{r}.npz"))
                          for r in range(world)]
    finally:
        t.join(JAX_TIMEOUT_S + 30)
    assert child and child[0].returncode == 0, (
        child[0].stdout[-2000:] + child[0].stderr[-4000:] if child
        else "the JAX child did not finish")
    out["jax"] = dict(np.load(jax_out))
    return out


def _stats(res) -> dict:
    return json.loads(str(res))


# -- shard_covering -----------------------------------------------------------

@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_shard_covering_matches_reference(synth_small, covering, t_cov,
                                          n_shards):
    census = synth_small.census
    j = j_shard(covering, census, n_shards, with_pool=True)
    t = shard_covering(t_cov, census, n_shards, with_pool=True,
                       device="cpu")
    for f in ("cell_lo", "cell_hi", "cell_val", "cand", "range_lo",
              "block_edges", "block_parent", "county_parent", "quant"):
        a, b = np.asarray(getattr(j, f)), getattr(t, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in ("blocks", "first", "count"):
        np.testing.assert_array_equal(np.asarray(getattr(j.edge_pool, f)),
                                      getattr(t.edge_pool, f).numpy(),
                                      err_msg=f)
    assert t.index_bytes_per_shard() == j.index_bytes_per_shard()
    assert (t.max_level, t.n_shards) == (j.max_level, j.n_shards)
    assert int(t.range_lo[0]) == 0
    # A rank moves its own row to the device, equal to the stacked row.
    for a, b in zip(t.shard(n_shards - 1),
                    (j.cell_lo, j.cell_hi, j.cell_val, j.cand)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b)[-1])


# -- one rank, in process -----------------------------------------------------

@pytest.fixture(scope="module")
def one_rank(synth_small, covering, t_cov, batches):
    """Every case on a (1, 1) mesh in both packages: {case: (repro ids +
    stats, port ids + stats)}."""
    census = synth_small.census
    jm, tm = j_mesh((1, 1)), make_test_mesh((1, 1))
    out = {}
    for name, (kw, batch) in SHARDED_CASES.items():
        cfg = JConfig(backend="ref", **BASE, **kw)
        je = JEngine.build(census, "fast", cfg, covering=covering)
        je.indices.sharded_index(1, with_pool=bool(cfg.fused))
        rj = jax.jit(lambda p: je.assign_sharded(p, jm))(
            jnp.asarray(batches[batch]))
        te = GeoEngine.build(census, "fast", EngineConfig(**BASE, **kw),
                             covering=t_cov, device="cpu")
        rt = te.assign_sharded(batches[batch], tm)
        out[name] = [{}, {}]
        record(out[name][0], "r", rj.state, rj.county, rj.block,
               rj.stats.as_dict())
        record(out[name][1], "r", rt.state, rt.county, rt.block,
               rt.stats.as_dict())
    for name, (kw, batch) in DIST_CASES.items():
        jc = JFastConfig(mode="exact", cap_boundary=DIST_CAP, backend="ref",
                         **kw)
        jidx = j_shard(covering, census, 1, with_pool=jc.fused)
        jres = jax.jit(lambda p: j_afd(jidx, p, jm, jc))(
            jnp.asarray(batches[batch]))
        tc = FastConfig(mode="exact", cap_boundary=DIST_CAP, **kw)
        tidx = shard_covering(t_cov, census, 1, with_pool=tc.fused,
                              device="cpu")
        tres = assign_fast_distributed(tidx, torch.from_numpy(
            batches[batch]), tm, tc)
        out[name] = [{}, {}]
        record(out[name][0], "r", *jres)
        record(out[name][1], "r", *tres)
    return out


@pytest.mark.parametrize("case", ALL_CASES)
def test_one_rank_matches_reference(one_rank, case):
    want, got = one_rank[case]
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_one_rank_off_extent_points_minus_one(one_rank, batches):
    """The 8 off-extent rows at the end of the batch come back -1 in all
    three ids, on every path that saw them."""
    for case in ("exact", "exact_fused", "approx", "dist", "dist_fused"):
        got = one_rank[case][1]
        for field in ("state", "county", "block"):
            np.testing.assert_array_equal(got[f"r/{field}"][-8:], -1,
                                          err_msg=f"{case} {field}")
        assert (got["r/block"][:-8] >= 0).all(), case


# -- several ranks: gloo CPU processes vs repro on fake devices ---------------

@pytest.mark.parametrize("shape", [s for v in MESHES.values() for s in v],
                         ids=mesh_tag)
@pytest.mark.parametrize("case", ALL_CASES)
def test_ranks_match_reference(multi, shape, case):
    """Every rank returns the whole batch's ids and stats, equal to
    ``repro``'s on the same mesh shape."""
    key = f"{mesh_tag(shape)}/{case}"
    want = multi["jax"]
    for r, got in enumerate(multi[int(np.prod(shape))]):
        for field in ("state", "county", "block", "stats"):
            np.testing.assert_array_equal(
                got[f"{key}/{field}"], want[f"{key}/{field}"],
                err_msg=f"rank {r}: {key}/{field}")


def test_mesh_rank_order(multi):
    """Ranks map to coordinates row-major, jax's device order."""
    for world, shapes in MESHES.items():
        for shape in shapes:
            for r, got in enumerate(multi[world]):
                want = np.unravel_index(r, shape)
                np.testing.assert_array_equal(
                    got[f"{mesh_tag(shape)}/coords"], want)


def test_drops_are_the_points_past_capacity(multi, synth_small, t_cov,
                                            batches):
    """With 3/4 of the batch in one shard and cap_shard 0.5, the points
    that come back -1 are exactly those past the first ``capacity`` of
    their shard's points in input order, and n_dropped counts them."""
    xy = batches["skewed"]
    owner = _owners(shard_covering(t_cov, synth_small.census, 4,
                                   device="cpu"), xy)
    capacity = capacity_for(len(xy), 0.5 / 4)
    rank_in_shard = np.zeros(len(xy), np.int64)
    for s in range(4):
        rows = np.flatnonzero(owner == s)
        rank_in_shard[rows] = np.arange(len(rows))
    dropped = rank_in_shard >= capacity
    for world in MESHES:
        for r, got in enumerate(multi[world]):
            key = f"{mesh_tag(MESHES[world][0])}/drop"
            st = _stats(got[f"{key}/stats"])
            assert st["n_dropped"] == int(dropped.sum()) > 0
            np.testing.assert_array_equal(got[f"{key}/block"] < 0, dropped)


def test_empty_shards_still_join(multi, synth_small, t_cov, batches):
    """One Morton range holds the whole batch, so three of the four
    shards' buckets are empty; every rank returns the full answer."""
    owner = _owners(shard_covering(t_cov, synth_small.census, 4,
                                   device="cpu"), batches["one_range"])
    assert (owner == RANGE_SHARD).all()
    for world in MESHES:
        key = f"{mesh_tag(MESHES[world][0])}/empty"
        for got in multi[world]:
            assert _stats(got[f"{key}/stats"])["n_dropped"] == 0
            assert (got[f"{key}/block"] >= 0).all()


# -- errors and capabilities --------------------------------------------------

def test_mesh_without_model_axis_raises(synth_small, t_cov, points_small):
    eng = GeoEngine.build(synth_small.census, "fast",
                          EngineConfig(**BASE), covering=t_cov, device="cpu")
    with pytest.raises(ValueError, match="model"):
        eng.assign_sharded(points_small[0], Mesh((1,), ("data",)))
    idx = shard_covering(t_cov, synth_small.census, 1, device="cpu")
    with pytest.raises(ValueError, match="model"):
        assign_fast_distributed(idx, torch.from_numpy(points_small[0]),
                                Mesh((1,), ("data",)))
    # The index's shard count must be the mesh's "model" size.
    idx2 = shard_covering(t_cov, synth_small.census, 2, device="cpu")
    with pytest.raises(ValueError, match="2 shards"):
        assign_fast_distributed(idx2, torch.from_numpy(points_small[0]),
                                make_test_mesh((1, 1)))


def test_sharded_engine_is_single_mesh_error():
    with pytest.raises(ValueError, match="single-mesh"):
        GeoEngine("sharded", EngineConfig())
    assert t_registry.sharded_strategies() == j_sharded_strategies() \
        == ("sharded",)
    assert not hasattr(t_registry, "NOT_PORTED")


def test_fused_without_pool_raises(synth_small, t_cov, points_small):
    idx = shard_covering(t_cov, synth_small.census, 1, device="cpu")
    with pytest.raises(ValueError, match="with_pool"):
        assign_fast_distributed(idx, torch.from_numpy(points_small[0]),
                                make_test_mesh((1, 1)),
                                FastConfig(fused=True))


def test_mesh_needs_a_process_group():
    """A mesh of several ranks without an initialized process group
    raises; a mesh of one needs none."""
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        make_test_mesh((2, 4))
    mesh = make_test_mesh((1, 1))
    x = torch.arange(3)
    assert mesh.size == 1 and mesh.psum(x, ("data", "model")) is x


def test_capabilities_list_sharded_counts(synth_small, covering, t_cov):
    """``capabilities()["sharded"]`` lists the built shard counts, and a
    new pool block size drops the sharded pools, as in ``repro``."""
    census = synth_small.census
    je = JEngine.build(census, "fast", JConfig(backend="ref", **BASE),
                       covering=covering)
    te = GeoEngine.build(census, "fast", EngineConfig(**BASE),
                         covering=t_cov, device="cpu")
    for n, pool in ((4, False), (2, True), (4, True)):
        je.indices.sharded_index(n, with_pool=pool)
        te.indices.sharded_index(n, with_pool=pool)
        assert te.indices.capabilities() == je.indices.capabilities()
    assert te.indices.capabilities()["sharded"] == [2, 4]
    je.indices.record_tuning({"be": 64})
    te.indices.record_tuning({"be": 64})
    for n in (2, 4):
        assert te.indices.sharded[n].edge_pool is None
        assert je.indices.sharded[n].edge_pool is None
    jp = je.indices.sharded_index(2, with_pool=True).edge_pool
    tp = te.indices.sharded_index(2, with_pool=True).edge_pool
    for f in ("blocks", "first", "count"):
        np.testing.assert_array_equal(np.asarray(getattr(jp, f)),
                                      getattr(tp, f).numpy(), err_msg=f)

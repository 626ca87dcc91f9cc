"""The port's artifact persistence (``GeoIndexSet.save`` / ``load`` /
``record_tuning``, ``GeoServer.from_artifact``) against the JAX
package's, on the CPU: an artifact saved by either package loads in the
other and in itself, and the engines built over it give equal ids,
``GeoStats`` and ``explain()`` for ``fast``, ``fast`` fused,
``fast_onepass``, ``hybrid`` and ``simple``; the two packages write the
same manifest and the same npz arrays for the same census and covering;
``load`` refuses what ``repro`` refuses, with the same messages; a tuned
pool block size repacks to ``repro``'s pool.  Tolerance: exact equality
(ids, counters, arrays and manifests).
"""
import dataclasses
import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.artifact import GeoIndexSet as JIndexSet
from repro.core.cells import build_cell_covering
from repro.core.engine import EngineConfig as JConfig
from repro.core.engine import GeoEngine as JEngine
from repro_torch.core import artifact as t_artifact
from repro_torch.core.artifact import GeoIndexSet
from repro_torch.core.cells import CellCovering
from repro_torch.core.engine import EngineConfig, GeoEngine
from repro_torch.core.geometry import CensusMap, PolygonSoup
from repro_torch.serving import GeoServer, ServeConfig

from covering_pair import shared_footprint, without_covering

CASES = {"fast": ("fast", {}), "fast_fused": ("fast", {"fused": True}),
         "fast_onepass": ("fast_onepass", {}), "hybrid": ("hybrid", {}),
         "simple": ("simple", {})}
BUCKETS = (64, 256, 1024)
N_POINTS = 1024


def _port_census(census) -> CensusMap:
    """The JAX package's census as the port's own classes (same arrays)."""
    soups = {lvl: PolygonSoup(**{f.name: getattr(getattr(census, lvl),
                                                 f.name)
                                 for f in dataclasses.fields(PolygonSoup)})
             for lvl in ("states", "counties", "blocks")}
    return CensusMap(extent=tuple(census.extent), **soups)


@pytest.fixture(scope="module")
def covering(synth_small):
    return build_cell_covering(synth_small.census, max_level=8)


@pytest.fixture(scope="module")
def points(synth_small, points_small):
    """The first N_POINTS of points_small plus off-extent and NaN rows."""
    x0, x1, y0, y1 = synth_small.census.extent
    extra = np.array([[x0 - 5.0, y0], [x1 + 1.0, y1], [np.nan, y0]],
                     np.float32)
    return np.concatenate([points_small[0][:N_POINTS], extra]).astype(
        np.float32)


@pytest.fixture(scope="module")
def saved(synth_small, covering, tmp_path_factory):
    """One artifact saved by each package from the same census and
    covering: {"repro": dir, "port": dir}."""
    root = tmp_path_factory.mktemp("artifacts")
    j_dir, t_dir = str(root / "repro"), str(root / "port")
    JIndexSet(census=synth_small.census, covering=covering,
              max_level=8).save(j_dir)
    GeoIndexSet(census=_port_census(synth_small.census),
                covering=CellCovering(**dataclasses.asdict(covering)),
                max_level=8, device="cpu").save(t_dir)
    return {"repro": j_dir, "port": t_dir}


def _ids(res):
    return [r.numpy() if isinstance(r, torch.Tensor) else np.asarray(r)
            for r in (res.state, res.county, res.block)]


def _engine(package, path, case):
    strategy, kw = CASES[case]
    if package == "repro":
        return JEngine.from_index_set(JIndexSet.load(path), strategy,
                                      JConfig(backend="ref", **kw))
    return GeoEngine.from_index_set(GeoIndexSet.load(path, device="cpu"),
                                    strategy, EngineConfig(**kw))


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("saver, loader", [("repro", "port"),
                                           ("port", "repro"),
                                           ("port", "port")])
def test_round_trip_matches_reference(saved, points, synth_small, covering,
                                      saver, loader, case):
    """An artifact saved by ``saver`` and loaded by ``loader`` gives the
    ids, GeoStats and plan of the JAX package's engine over its own
    reload of the same artifact (repro -> repro is the reference)."""
    ref = _engine("repro", saved["repro"], case)
    got = _engine(loader, saved[saver], case)
    rr = ref.assign(jnp.asarray(points))
    rg = got.assign(jnp.asarray(points) if loader == "repro" else points)
    for a, b in zip(_ids(rr), _ids(rg)):
        np.testing.assert_array_equal(a, b)
    assert rr.stats.as_dict() == rg.stats.as_dict()
    assert ref.explain() == (without_covering(got) if loader == "port"
                             else got.explain())
    assert ref.indices.capabilities() == got.indices.capabilities()
    # And the reload maps as the engine built from the census does.
    strategy, kw = CASES[case]
    warm = GeoEngine.build(
        synth_small.census, strategy, EngineConfig(max_level=8, **kw),
        covering=CellCovering(**dataclasses.asdict(covering)), device="cpu")
    for a, b in zip(_ids(warm.assign(points)), _ids(rg)):
        np.testing.assert_array_equal(a, b)


def test_manifest_and_arrays_equal(saved):
    """Both packages write the same manifest and the same npz: keys,
    dtypes and values."""
    manifests = [json.load(open(os.path.join(saved[p],
                                             t_artifact.MANIFEST_NAME)))
                 for p in ("repro", "port")]
    assert manifests[0] == manifests[1]
    assert manifests[1]["schema_version"] == 2
    assert manifests[1]["components"] == ["census", "covering"]
    with np.load(os.path.join(saved["repro"], t_artifact.ARRAYS_NAME)) as j, \
            np.load(os.path.join(saved["port"], t_artifact.ARRAYS_NAME)) as t:
        assert sorted(j.files) == sorted(t.files)
        for k in j.files:
            assert j[k].dtype == t[k].dtype, k
            np.testing.assert_array_equal(j[k], t[k], err_msg=k)
        assert t["extent"].dtype == np.float64
    # The format constants are the JAX package's.
    from repro.core import artifact as j_artifact
    for name in ("SCHEMA_VERSION", "ACCEPTED_SCHEMA_VERSIONS",
                 "MANIFEST_NAME", "ARRAYS_NAME", "FORMAT_NAME"):
        assert getattr(t_artifact, name) == getattr(j_artifact, name)


def _edit_manifest(src, dst, edit):
    shutil.copytree(src, dst)
    path = os.path.join(dst, t_artifact.MANIFEST_NAME)
    manifest = json.load(open(path))
    edit(manifest)
    with open(path, "w") as f:
        json.dump(manifest, f)
    return dst


@pytest.mark.parametrize("fault", ["missing", "format", "schema3"])
def test_load_refuses_as_reference(saved, tmp_path, fault):
    """A missing manifest, a foreign format and schema_version 3 raise
    ValueError in both packages, with the same message."""
    if fault == "missing":
        path = str(tmp_path / "empty")
        os.makedirs(path)
    else:
        key, value = (("format", "something-else") if fault == "format"
                      else ("schema_version", 3))
        path = _edit_manifest(saved["port"], str(tmp_path / fault),
                              lambda m: m.update({key: value}))
    with pytest.raises(ValueError) as j_err:
        JIndexSet.load(path)
    with pytest.raises(ValueError) as t_err:
        GeoIndexSet.load(path, device="cpu")
    assert str(t_err.value) == str(j_err.value)
    if fault == "schema3":
        assert "unsupported schema_version 3" in str(t_err.value)


def test_v1_manifest_loads_with_empty_tuning(saved, tmp_path, points):
    def to_v1(m):
        m["schema_version"] = 1
        del m["tuning"]
    path = _edit_manifest(saved["port"], str(tmp_path / "v1"), to_v1)
    t_set = GeoIndexSet.load(path, device="cpu")
    assert t_set.tuning == {} == JIndexSet.load(path).tuning
    assert t_set.device == "cpu" and t_set.covering is not None
    eng = GeoEngine.from_index_set(t_set, "fast")
    ref = _engine("repro", saved["repro"], "fast")
    for a, b in zip(_ids(ref.assign(jnp.asarray(points))),
                    _ids(eng.assign(points))):
        np.testing.assert_array_equal(a, b)


def test_record_tuning_drops_and_repacks_pools(synth_small, covering):
    """A new ``be`` drops the built fast and simple pools; the repack at
    BE 64 is the JAX package's pool at BE 64.  An unchanged ``be`` keeps
    them."""
    t_set = GeoIndexSet.build(
        _port_census(synth_small.census), components=("fast", "simple"),
        pools=("fast", "simple"), max_level=8,
        covering=CellCovering(**dataclasses.asdict(covering)), device="cpu")
    j_set = JIndexSet.build(synth_small.census, components=("fast",),
                            pools=("fast", "simple"), max_level=8,
                            covering=covering)
    kept = t_set.fast.edge_pool
    t_set.record_tuning({"winner": "fast", "be": 256})
    assert t_set.fast.edge_pool is kept and t_set.pool_be() == 256
    t_set.record_tuning({"be": 64})
    j_set.record_tuning({"be": 64})
    assert t_set.fast.edge_pool is None
    assert t_set.simple.state_pool is None
    assert t_set.simple.county_pool is None
    assert t_set.simple.block_pool is None
    assert not t_set.capabilities()["fast_pool"]
    assert t_set.tuning == {"winner": "fast", "be": 64}
    t_set.ensure("fast", pool=True)
    t_set.ensure("simple", pool=True)
    j_set.ensure("fast", pool=True)
    j_set.ensure("simple", pool=True)
    pairs = [(t_set.fast.edge_pool, j_set.fast.edge_pool)] + [
        (getattr(t_set.simple, f"{lvl}_pool"),
         getattr(j_set.simple, f"{lvl}_pool"))
        for lvl in ("state", "county", "block")]
    for tp, jp in pairs:
        assert tp.be == 64 and jp.blocks.shape[2] == 64
        for f in ("blocks", "first", "count"):
            np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                          np.asarray(getattr(jp, f)))
    jfp = j_set.memory_footprint()
    assert shared_footprint(t_set, jfp) == jfp


def test_from_artifact_serves_as_warm_server(saved, synth_small, covering,
                                            points, tmp_path):
    """``GeoServer.from_artifact`` (on the CPU when asked) serves the warm
    server's ids; a tuning record from another device kind does not move
    the plan, one from this device kind does."""
    cfg = ServeConfig(buckets=BUCKETS)
    warm = GeoServer(GeoEngine.build(
        synth_small.census, "fast", EngineConfig(max_level=8),
        covering=CellCovering(**dataclasses.asdict(covering)),
        device="cpu"), cfg)
    cold = GeoServer.from_artifact(saved["port"], cfg=cfg, device="cpu")
    eng = cold.regions[0].engine
    assert eng.device.type == "cpu" and eng.strategy == "fast"
    assert eng.explain()["auto"] and eng.covering is not None
    a, b = warm.submit(points), cold.submit(points)
    for f in ("state", "county", "block", "region"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert cold.stats[0].as_dict() == warm.stats[0].as_dict()
    tuned = {"winner": "fast_onepass", "be": 256, "pts_per_sec": 1e9}
    for kind, want in (("tpu", "fast"), ("cpu", "fast_onepass")):
        path = _edit_manifest(
            saved["port"], str(tmp_path / kind),
            lambda m: m["tuning"].update(tuned, device_kind=kind))
        srv = GeoServer.from_artifact(path, cfg=cfg, device="cpu")
        plan = srv.regions[0].engine.explain()
        assert plan["strategy"] == want, plan
        j_plan = JEngine.from_index_set(JIndexSet.load(path), "auto",
                                        JConfig(backend="ref")).explain()
        assert j_plan["strategy"] == want
        np.testing.assert_array_equal(srv.submit(points).block, a.block)

"""The port's engine (``repro_torch.core.engine.GeoEngine`` on the CPU)
against the JAX package's with ``backend="ref"``: the same census,
covering and points give equal state / county / block ids and equal
``GeoStats`` counters (the per-level ``extra`` breakdown included) for
``simple`` (default caps, fused, overflowing caps), ``fast`` (approx,
exact, exact+fused, and exact configs whose caps overflow),
``fast_onepass`` and ``hybrid`` (plain and fused), through ``assign``,
``assign_padded``, the extent handles and the planner.  Tolerance: exact
equality.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.artifact import GeoIndexSet as JIndexSet
from repro.core.cells import build_cell_covering
from repro.core.compact import capacity_for
from repro.core.engine import EngineConfig as JConfig
from repro.core.engine import GeoEngine as JEngine
from repro.core.fast import cell_values as j_cell_values
from repro.core.plan import plan_for as JPlanFor
from repro.core.registry import sharded_strategies as j_sharded_strategies
from repro.core.resolve import resolve_candidates as j_resolve
from repro_torch.core import plan as t_plan
from repro_torch.core.artifact import GeoIndexSet
from repro_torch.core.cells import CellCovering
from repro_torch.core.engine import EngineConfig, GeoEngine
from repro_torch.core.registry import get_strategy
from repro_torch.core.registry import \
    sharded_strategies as t_sharded_strategies
from repro_torch.core.resolve import resolve_candidates as t_resolve
from repro_torch.launch.mesh import make_test_mesh

from covering_pair import shared_footprint, without_covering

CASES = {
    "simple": ("simple", dict()),
    "simple_fused": ("simple", dict(fused=True)),
    "simple_capped": ("simple", dict(cap_state=0.01)),
    "hybrid": ("hybrid", dict()),
    "hybrid_fused": ("hybrid", dict(fused=True)),
    "approx": ("fast", dict(mode="approx")),
    "exact": ("fast", dict()),
    "exact_fused": ("fast", dict(fused=True)),
    "exact_capped": ("fast", dict(cap_boundary=0.01)),
    "exact_fused_capped": ("fast", dict(cap_boundary=0.01, fused=True)),
    "onepass": ("fast_onepass", dict()),
    "onepass_cfg": ("fast", dict(fused="onepass")),
}


@pytest.fixture(scope="module")
def covering(synth_small):
    """One covering BFS (max_level 8), handed to both packages."""
    return build_cell_covering(synth_small.census, max_level=8)


@pytest.fixture(scope="module")
def engines(synth_small, covering):
    census = synth_small.census
    t_cov = CellCovering(**dataclasses.asdict(covering))
    out = {}
    for name, (strategy, kw) in CASES.items():
        out[name] = (
            JEngine.build(census, strategy,
                          JConfig(backend="ref", max_level=8, **kw),
                          covering=covering),
            GeoEngine.build(census, strategy,
                            EngineConfig(max_level=8, **kw),
                            covering=t_cov, device="cpu"))
    return out


@pytest.fixture(scope="module")
def points(synth_small, points_small):
    """points_small plus off-extent, FAR and NaN rows."""
    x0, x1, y0, y1 = synth_small.census.extent
    extra = np.array([[x0 - 5.0, y0], [1e30, 1e30], [x1 + 1.0, y1],
                      [0.0, 1e30], [np.nan, y0], [1e30, y0]], np.float32)
    return np.concatenate([points_small[0], extra]).astype(np.float32)


def _ids(res):
    return [np.asarray(a) if not isinstance(a, torch.Tensor)
            else a.numpy() for a in (res.state, res.county, res.block)]


def _ints(tree):
    """A nested stats dict with every counter as a python int."""
    return {k: _ints(v) if isinstance(v, dict) else int(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_assign_matches_reference(engines, points, points_small, case):
    j, t = engines[case]
    rj, rt = j.assign(jnp.asarray(points)), t.assign(points)
    for a, b in zip(_ids(rj), _ids(rt)):
        np.testing.assert_array_equal(a, b)
    assert rj.stats.as_dict() == rt.stats.as_dict()
    assert _ints(rj.stats.extra) == _ints(rt.stats.extra)
    block = _ids(rt)[2]
    assert (block[-6:] == -1).all()
    if case != "approx" and "capped" not in case:
        np.testing.assert_array_equal(block[:len(points_small[1])],
                                      points_small[1])
    if "capped" in case:
        assert rt.stats.as_dict()["overflow"] > 0


@pytest.mark.parametrize("case", ["exact", "exact_fused", "onepass",
                                  "simple", "simple_fused", "hybrid"])
def test_assign_padded_matches_reference(engines, points, case):
    j, t = engines[case]
    padded = np.zeros((1024, 2), np.float32)
    padded[:1000] = points[:1000]
    rj = j.assign_padded(jnp.asarray(padded), 1000)
    rt = t.assign_padded(padded, 1000)
    for a, b in zip(_ids(rj), _ids(rt)):
        np.testing.assert_array_equal(a, b)
        assert (b[1000:] == -1).all()
    assert rj.stats.as_dict() == rt.stats.as_dict()
    assert rt.stats.as_dict() == t.assign(points[:1000]).stats.as_dict()


@pytest.mark.parametrize("case", ["exact", "simple"])
def test_extent_and_parent_handles_match(engines, points, case):
    """Also on a simple-only engine: the extent from the census, the
    parents from the simple index."""
    j, t = engines[case]
    assert (t.fast_index is None) == (case == "simple")
    np.testing.assert_array_equal(j.extent_contains(points),
                                  t.extent_contains(points))
    jq, jl = j.extent_quant()
    tq, tl = t.extent_quant()
    np.testing.assert_array_equal(jq, tq)
    assert jl == tl
    for a, b in zip(j.host_parents(), t.host_parents()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", ["exact", "exact_fused", "onepass",
                                  "simple", "simple_fused", "hybrid",
                                  "hybrid_fused"])
def test_explain_and_footprint_match(engines, case):
    j, t = engines[case]
    assert j.explain() == without_covering(t)
    # The footprint counts the pool as the JAX package does (blocks,
    # first, count); the port's ``live`` [P] i32 is left out of it.
    jfp = j.indices.memory_footprint()
    assert shared_footprint(t.indices, jfp) == jfp
    assert j.indices.capabilities() == t.indices.capabilities()


def test_auto_plan_matches_reference(synth_small, covering):
    """strategy="auto" lands on the same plan (the reasons' wording for
    the device rule differs; the choice does not)."""
    census = synth_small.census
    j = JEngine.build(census, "auto", JConfig(backend="ref", max_level=8),
                      covering=covering)
    t = GeoEngine.build(census, "auto", EngineConfig(max_level=8),
                        covering=CellCovering(**dataclasses.asdict(covering)),
                        device="cpu")
    keys = ("strategy", "mode", "fused", "sharded", "device_kind",
            "boundary_fraction", "auto")
    assert {k: j.explain()[k] for k in keys} == \
        {k: t.explain()[k] for k in keys}
    assert t.strategy == "fast"


def test_from_index_set_matches_reference(synth_small, covering, points):
    """An engine over an existing artifact (the planner reading its
    capabilities) plans and assigns as the reference's does."""
    census = synth_small.census
    j = JEngine.from_index_set(
        JIndexSet(census=census, covering=covering, max_level=8), "auto",
        JConfig(backend="ref"))
    t = GeoEngine.from_index_set(
        GeoIndexSet(census=census,
                    covering=CellCovering(**dataclasses.asdict(covering)),
                    max_level=8, device="cpu"), "auto")
    assert (j.strategy, j.cfg.fused, j.cfg.max_level) == \
        (t.strategy, t.cfg.fused, t.cfg.max_level)
    rj, rt = j.assign(jnp.asarray(points)), t.assign(points)
    for a, b in zip(_ids(rj), _ids(rt)):
        np.testing.assert_array_equal(a, b)
    assert rj.stats.as_dict() == rt.stats.as_dict()


@pytest.mark.parametrize("two_phase", [True, False])
@pytest.mark.parametrize("fallback", ["first", "prior"])
@pytest.mark.parametrize("pool, frac", [(False, 1.0), (True, 0.02)])
def test_resolve_candidates_matches_reference(engines, points, two_phase,
                                              fallback, pool, frac):
    """Both schedules, both fallbacks, both PIP data paths, with roomy
    and overflowing caps: equal assignments and counters."""
    j, t = engines["onepass"]
    jidx, tidx = j.fast_index, t.fast_index
    jp = jnp.asarray(points)
    val = np.asarray(j_cell_values(jidx, jp))
    need = (val < 0) & (val > -2**30)
    table = np.asarray(jidx.cand)
    cand = table[np.clip(-(val + 1), 0, len(table) - 1)]
    prior = np.where(val >= 0, val, -1).astype(np.int32)
    cap = capacity_for(len(points), frac)
    aj, sj = j_resolve(
        jp, jnp.asarray(cand), jidx.block_edges, jnp.asarray(need),
        cap=cap, backend="ref", prior=jnp.asarray(prior),
        fallback=fallback, two_phase=two_phase,
        edge_pool=jidx.edge_pool if pool else None)
    at, st = t_resolve(
        torch.from_numpy(points), torch.from_numpy(cand),
        tidx.block_edges, torch.from_numpy(need), cap=cap,
        prior=torch.from_numpy(prior), fallback=fallback,
        two_phase=two_phase, edge_pool=tidx.edge_pool if pool else None)
    np.testing.assert_array_equal(np.asarray(aj), at.numpy())
    for f in ("n_need", "n_pip", "overflow", "phase2_miss"):
        assert int(getattr(sj, f)) == int(getattr(st, f)), f
    if frac < 1.0:
        assert int(st.overflow) > 0


def test_unported_choices_raise(engines, points):
    """The choices that raised NotImplementedError before the sharded
    lookup was ported now resolve as in ``repro``: the ``sharded``
    strategy, ``sharded_strategies()``, and ``assign_sharded`` on a
    (1, 1) mesh, whose ids equal the engine's own exact ``assign``."""
    assert get_strategy("sharded").caps.supports_sharded
    assert t_sharded_strategies() == j_sharded_strategies() == ("sharded",)
    eng = engines["exact"][1]
    res = eng.assign_sharded(points, make_test_mesh((1, 1)))
    want = eng.assign(points)
    for a, b in zip(_ids(res), _ids(want)):
        np.testing.assert_array_equal(a, b)
    assert int(res.stats.extra["n_dropped"]) == 0


def test_default_strategy_matches_reference(synth_small, points):
    """``GeoEngine.build(census)`` builds the simple cascade in both
    packages, with the same plan and the same answers."""
    census = synth_small.census
    j = JEngine.build(census)
    t = GeoEngine.build(census, device="cpu")
    assert j.strategy == t.strategy == "simple"
    assert j.explain() == without_covering(t)
    assert j.indices.capabilities() == t.indices.capabilities()
    rj, rt = j.assign(jnp.asarray(points)), t.assign(points)
    for a, b in zip(_ids(rj), _ids(rt)):
        np.testing.assert_array_equal(a, b)
    assert rj.stats.as_dict() == rt.stats.as_dict()


@pytest.mark.parametrize("fused", [False, True, "onepass"])
def test_heavy_boundary_plan_matches_reference(covering, fused):
    """A covering whose boundary fraction is >= 0.35 plans ``hybrid`` as
    the reference does, with the same fused choice and reasons; a
    "onepass" request keeps the two-kernel fused path.  The device
    rule's wording differs (the port names the card, not the TPU), so
    with fused=False the last reason is only checked for its device."""
    heavy = dataclasses.replace(covering, val=-np.ones_like(covering.val))
    j = JPlanFor(JConfig(backend="ref", fused=fused), covering=heavy,
                 device_kind="cpu").as_dict()
    t = t_plan.plan_for(EngineConfig(fused=fused), covering=heavy,
                        device_kind="cpu").as_dict()
    assert t["strategy"] == "hybrid"
    assert t["fused"] == (fused is not False)
    if fused is False:
        assert "'cpu'" in t["reasons"][-1]
        j["reasons"], t["reasons"] = j["reasons"][:-1], t["reasons"][:-1]
    assert j == t


def test_auto_builds_hybrid_on_heavy_boundary(synth_small, covering,
                                              points):
    """strategy="auto" over a heavy-boundary covering builds hybrid (no
    longer raises) and assigns as the reference's engine does."""
    census = synth_small.census
    heavy = dataclasses.replace(covering, val=-np.ones_like(covering.val),
                                cand=covering.cand[:1])
    j = JEngine.build(census, "auto", JConfig(backend="ref", max_level=8),
                      covering=heavy)
    t = GeoEngine.build(census, "auto", EngineConfig(max_level=8),
                        covering=CellCovering(**dataclasses.asdict(heavy)),
                        device="cpu")
    assert j.strategy == t.strategy == "hybrid"
    assert j.explain()["fused"] == t.explain()["fused"]
    rj, rt = j.assign(jnp.asarray(points)), t.assign(points)
    for a, b in zip(_ids(rj), _ids(rt)):
        np.testing.assert_array_equal(a, b)
    assert rj.stats.as_dict() == rt.stats.as_dict()
    assert rt.stats.as_dict()["overflow"] > 0


def test_fused_over_poolless_index_fails_at_build(engines):
    _, t = engines["approx"]
    with pytest.raises(ValueError, match="with_pool"):
        GeoEngine("fast", EngineConfig(max_level=8, fused=True),
                  indices=dataclasses.replace(
                      t.indices, fast=dataclasses.replace(
                          t.fast_index, edge_pool=None)))


# ---------------------------------------------- the CUDA rule for fused
def _cuda_plan(covering, capabilities=None, **kw):
    """``plan_for`` on the ``synth_small`` covering, planned for a card."""
    return t_plan.plan_for(EngineConfig(max_level=8, **kw),
                           covering=CellCovering(
                               **dataclasses.asdict(covering)),
                           capabilities=capabilities, device_kind="cuda")


CAPS = {"census": dict(census=True, covering=True),
        "pool": dict(fast=True, fast_pool=True),
        "fresh": None}


@pytest.mark.parametrize("caps", list(CAPS))
def test_cuda_rule_plans_onepass_for_exact_fast(covering, caps):
    """Exact ``fast`` on a card with a census to pack a pool from, a
    built pool, or a fresh build: the one-pass kernel, for the rule's
    measured reason."""
    plan = _cuda_plan(covering, CAPS[caps])
    assert (plan.strategy, plan.mode, plan.fused) == ("fast", "exact",
                                                      "onepass")
    assert plan.reasons[-1] == t_plan.ONEPASS_CUDA_REASON
    assert plan.device_rule and plan.as_dict()["fused"] == "onepass"
    assert "device_rule" not in plan.as_dict()


@pytest.mark.parametrize("case, kw, caps, device, want", [
    ("no_pool", {}, dict(fast=True), "cuda", False),
    ("approx", dict(mode="approx"), CAPS["census"], "cuda", False),
    ("cpu", {}, CAPS["census"], "cpu", False),
    ("fused_true", dict(fused=True), CAPS["census"], "cuda", True),
    ("fused_onepass", dict(fused="onepass"), CAPS["census"], "cuda",
     "onepass"),
])
def test_cuda_rule_leaves_other_plans_alone(covering, case, kw, caps,
                                            device, want):
    """No pool at hand, approx mode, the CPU and an explicit ``fused``
    plan as before the rule; the CPU plan equals the JAX package's."""
    cov = CellCovering(**dataclasses.asdict(covering))
    plan = t_plan.plan_for(EngineConfig(max_level=8, **kw), covering=cov,
                           capabilities=caps, device_kind=device)
    assert plan.strategy == "fast" and plan.fused == want
    assert not plan.device_rule
    assert t_plan.ONEPASS_CUDA_REASON not in plan.reasons
    if device == "cpu":
        j = JPlanFor(JConfig(backend="ref", max_level=8, **kw),
                     covering=covering, capabilities=caps,
                     device_kind="cpu").as_dict()
        assert {k: v for k, v in j.items() if k != "reasons"} == \
            {k: v for k, v in plan.as_dict().items() if k != "reasons"}


@pytest.mark.parametrize("fused", [False, True])
def test_cuda_rule_keeps_heavy_boundary_on_hybrid(covering, fused):
    """A heavy-boundary covering plans ``hybrid`` on a card, its
    ``fused`` as the config has it."""
    heavy = dataclasses.replace(covering, val=-np.ones_like(covering.val))
    plan = _cuda_plan(heavy, CAPS["census"], fused=fused)
    assert (plan.strategy, plan.fused) == ("hybrid", fused)
    assert not plan.device_rule


def test_explicit_strategies_ignore_the_cuda_rule():
    """A pinned ``fast`` keeps the config's ``fused`` on a card; a pinned
    ``fast_onepass`` is the one-pass kernel by request, not by rule."""
    fast = t_plan.explicit_plan("fast", EngineConfig(), "cuda")
    onepass = t_plan.explicit_plan("fast_onepass", EngineConfig(), "cuda")
    assert (fast.fused, fast.device_rule) == (False, False)
    assert (onepass.fused, onepass.device_rule) == ("onepass", False)


@pytest.mark.parametrize("fused, planned, with_pool", [
    (False, "onepass", False),       # the rule: the sharded route as before
    (True, True, True),
    ("onepass", "onepass", True),    # an explicit onepass: the pool path
])
def test_auto_engine_sharded_route_keeps_its_data_path(
        synth_small, covering, points, monkeypatch, fused, planned,
        with_pool):
    """An engine planned for a card (its index on the CPU, so the twins
    run) asks ``sharded_index`` for the pool exactly when a config's
    ``fused`` did before the rule; the sharded ids equal its own."""
    monkeypatch.setattr(t_plan, "device_kind_of", lambda device=None:
                        "cuda")
    idx = GeoIndexSet(census=synth_small.census,
                      covering=CellCovering(**dataclasses.asdict(covering)),
                      max_level=8, device="cpu")
    eng = GeoEngine.from_index_set(idx, "auto", EngineConfig(fused=fused))
    assert (eng.strategy, eng.explain()["fused"]) == ("fast", planned)
    asked = []
    real = idx.sharded_index

    def spy(n_shards, with_pool=False):
        asked.append(with_pool)
        return real(n_shards, with_pool=with_pool)

    monkeypatch.setattr(idx, "sharded_index", spy)
    res = eng.assign_sharded(points, make_test_mesh((1, 1)))
    assert asked == [with_pool]
    assert (idx.sharded[1].edge_pool is not None) == with_pool
    for a, b in zip(_ids(res), _ids(eng.assign(points))):
        np.testing.assert_array_equal(a, b)

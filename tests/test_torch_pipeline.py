"""The port's geo enrichment and data pipeline (``core.enrich``,
``core.fast.demorton``, ``data.pipeline``) and ``GeoEngine``'s legacy
index keywords against the JAX package's, on the CPU.

``enrich`` and ``demorton`` are held equal to ``repro``'s on the same
inputs.  The pipeline's draws cannot match ``jax.random``'s bits, so its
arithmetic is held instead: the JAX package's own ``SyntheticLM`` and
``GeoEnriched._sample_points`` run with ``jax.random`` replaced by the
same numpy draws the port's ``lm_tokens`` and ``cell_points`` get.
Tolerance: exact for ids, tokens and features; points within 1 ulp (and
equal block ids).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as j_reduced_config
from repro.core.cells import build_cell_covering
from repro.core.engine import EngineConfig as JConfig
from repro.core.engine import GeoEngine as JEngine
from repro.core.enrich import enrich as j_enrich
from repro.core.fast import FastConfig as JFastConfig
from repro.core.fast import FastIndex as JFastIndex
from repro.core.fast import demorton as j_demorton
from repro.core.simple import SimpleIndex as JSimpleIndex
from repro.data.pipeline import GeoEnriched as JGeoEnriched
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro_torch.configs import ShapeConfig, get_reduced_config
from repro_torch.core.cells import CellCovering
from repro_torch.core.engine import EngineConfig, GeoEngine
from repro_torch.core.enrich import enrich
from repro_torch.core.fast import FastConfig, FastIndex, demorton
from repro_torch.core.simple import SimpleIndex
from repro_torch.data import (GeoEnriched, SyntheticLM, cell_points,
                              lm_tokens, make_source)
from repro_torch.kernels.cascade import morton

from covering_pair import without_covering

ARCH = "qwen1.5-0.5b"


@pytest.fixture(scope="module")
def indices(synth_small):
    """(JAX fast index, port fast index on the CPU) over one covering."""
    cov = build_cell_covering(synth_small.census, max_level=8)
    return (JFastIndex.from_covering(cov, synth_small.census, gbits=4),
            FastIndex.from_covering(CellCovering(**dataclasses.asdict(cov)),
                                    synth_small.census, gbits=4,
                                    device="cpu"))


@pytest.fixture(scope="module")
def fast_engine(indices):
    return GeoEngine("fast", EngineConfig(cap_boundary=1.0),
                     fast_index=indices[1])


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# -- enrich / demorton --------------------------------------------------------

def test_enrich_matches_repro(synth_small, indices):
    """2,048 sampled points plus off-map ones: block, county, state,
    feature token (OOV bucket included) and stats equal ``repro``'s."""
    j_idx, t_idx = indices
    xy, bid, cid, sid = synth_small.sample_points(
        np.random.default_rng(3), 2048)
    x0, x1, y0, y1 = synth_small.census.extent
    xy = np.concatenate([xy, np.array([[x0 - 1.0, y0], [x1 + 3.0, y1]],
                                      np.float32)])
    want = j_enrich(j_idx, jnp.asarray(xy),
                    JFastConfig(mode="exact", cap_boundary=1.0,
                                backend="ref"), n_feature_tokens=100)
    got = enrich(t_idx, xy, FastConfig(mode="exact", cap_boundary=1.0),
                 n_feature_tokens=100)
    for key in ("block", "county", "state", "feature_token"):
        assert got[key].dtype == torch.int32, key
        np.testing.assert_array_equal(_np(got[key]), _np(want[key]),
                                      err_msg=key)
    assert {k: int(v) for k, v in got["stats"].items()} == \
        {k: int(v) for k, v in want["stats"].items()}
    np.testing.assert_array_equal(_np(got["block"])[:-2], bid)
    assert (_np(got["feature_token"])[-2:] == 100).all()


def test_demorton_matches_repro():
    codes = np.random.default_rng(0).integers(0, 1 << 30, 4096,
                                              dtype=np.int64).astype(np.int32)
    codes[:3] = (0, 1, (1 << 30) - 1)
    ix, iy = demorton(torch.from_numpy(codes))
    jx, jy = j_demorton(jnp.asarray(codes))
    np.testing.assert_array_equal(ix.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(iy.numpy(), np.asarray(jy))
    assert ix.dtype == torch.int32
    np.testing.assert_array_equal(morton(ix, iy).numpy(), codes)


# -- the pipeline's arithmetic on the same draws ------------------------------

def _patch_draws(monkeypatch, ints, floats=None, bits=None):
    """Replace jax.random's draws by numpy arrays chosen by shape."""
    monkeypatch.setattr(jax.random, "randint",
                        lambda key, shape, lo, hi: jnp.asarray(
                            ints[tuple(shape)]))
    if floats is not None:
        monkeypatch.setattr(jax.random, "uniform",
                            lambda key, shape: jnp.asarray(floats))
    if bits is not None:
        monkeypatch.setattr(jax.random, "bernoulli",
                            lambda key, p, shape: jnp.asarray(bits))


@pytest.mark.parametrize("batch, seq", [(4, 32), (3, 300)])
def test_lm_tokens_match_repro_formula(monkeypatch, batch, seq):
    """The same (topic, base, use_bias) draws give ``repro``'s
    SyntheticLM tokens and labels exactly."""
    rng = np.random.default_rng(batch * seq)
    cfg = j_reduced_config(ARCH)
    topic = rng.integers(0, 64, (batch, 1)).astype(np.int32)
    base = rng.integers(0, cfg.vocab, (batch, seq + 1)).astype(np.int32)
    use_bias = rng.random((batch, seq + 1)) < 0.5
    _patch_draws(monkeypatch, {(batch, 1): topic, (batch, seq + 1): base},
                 bits=use_bias)
    want = JSyntheticLM(cfg=cfg, batch=batch, seq=seq).batch_at(0)
    monkeypatch.undo()
    toks = lm_tokens(torch.from_numpy(topic), torch.from_numpy(base),
                     torch.from_numpy(use_bias), cfg.vocab)
    assert toks.dtype == torch.int32
    np.testing.assert_array_equal(toks[:, :-1].numpy(),
                                  np.asarray(want["tokens"]))
    np.testing.assert_array_equal(toks[:, 1:].numpy(),
                                  np.asarray(want["labels"]))


def test_cell_points_match_repro_formula(monkeypatch, synth_small, indices):
    """The same (cell, jitter) draws give ``repro``'s sampled points
    within 1 ulp, and the same block ids."""
    j_idx, t_idx = indices
    n = 2048
    rng = np.random.default_rng(9)
    r = rng.integers(0, t_idx.cell_lo.shape[0], n).astype(np.int32)
    u = rng.random((n, 2), dtype=np.float32)
    u[:2] = (0.0, np.float32(1.0) - np.float32(2.0 ** -24))
    _patch_draws(monkeypatch, {(n,): r}, floats=u)
    want = np.asarray(JGeoEnriched(
        source=None, fast_index=j_idx,
        fast_cfg=JFastConfig(backend="ref"))._sample_points(
            jax.random.key(0), n))
    monkeypatch.undo()
    got = cell_points(t_idx, torch.from_numpy(r).long(),
                      torch.from_numpy(u))
    assert got.dtype == torch.float32
    np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=1)
    eng = GeoEngine("fast", EngineConfig(cap_boundary=1.0),
                    fast_index=t_idx)
    j_eng = JEngine("fast", JConfig(backend="ref", cap_boundary=1.0),
                    fast_index=j_idx)
    np.testing.assert_array_equal(
        eng.assign(got).block.numpy(),
        np.asarray(j_eng.assign(jnp.asarray(want)).block))


def test_batch_is_a_function_of_seed_and_step(fast_engine):
    """batch_at(5) twice, and from a fresh source, is the same batch;
    another step or seed is another; no state is kept between calls."""
    cfg = get_reduced_config(ARCH)
    src = make_source(cfg, ShapeConfig("t", 64, 8, "train"), seed=1,
                      geo=fast_engine, device="cpu")
    a, b = src.batch_at(5), src.batch_at(5)
    src.batch_at(6)
    c = make_source(cfg, ShapeConfig("t", 64, 8, "train"), seed=1,
                    geo=fast_engine, device="cpu").batch_at(5)
    for key in ("tokens", "labels", "geo_block"):
        assert torch.equal(a[key], b[key]) and torch.equal(a[key], c[key])
    assert a["tokens"].shape == (8, 64) and a["tokens"].dtype == torch.int32
    assert not torch.equal(a["tokens"], src.batch_at(6)["tokens"])
    other = make_source(cfg, ShapeConfig("t", 64, 8, "train"), seed=2,
                        device="cpu").batch_at(5)
    assert not torch.equal(a["labels"], other["labels"])
    # The draws are CPU draws moved to the device: tokens are lm_tokens
    # of SyntheticLM.draws, the first replaced by the geo token.
    d = src.source.draws(5)
    toks = lm_tokens(d["topic"], d["base"], d["use_bias"], cfg.vocab)
    assert torch.equal(a["labels"], toks[:, 1:])
    assert torch.equal(a["tokens"][:, 1:], toks[:, 1:-1])
    geo = (a["geo_block"].clamp(min=0) % 1024) % cfg.vocab
    assert torch.equal(a["tokens"][:, 0], geo.to(torch.int32))


# -- mirrors of tests/test_pipeline_enrich.py ---------------------------------

def test_enrich_operator(synth_small, indices):
    _, idx = indices
    xy, bid, cid, sid = synth_small.sample_points(
        np.random.default_rng(3), 2048)
    out = enrich(idx, xy, FastConfig(mode="exact", cap_boundary=1.0))
    np.testing.assert_array_equal(out["block"].numpy(), bid)
    np.testing.assert_array_equal(out["state"].numpy(), sid)
    ft = out["feature_token"].numpy()
    assert ((0 <= ft) & (ft <= 1024)).all()


def test_geo_enriched_pipeline_deterministic(indices):
    """The legacy ``fast_index=`` / ``fast_cfg=`` spelling."""
    _, idx = indices
    cfg = get_reduced_config(ARCH)
    src = GeoEnriched(source=SyntheticLM(cfg=cfg, batch=4, seq=32, seed=1,
                                         device="cpu"),
                      fast_index=idx, fast_cfg=FastConfig(mode="approx"))
    a = src.batch_at(5)
    b = src.batch_at(5)
    np.testing.assert_array_equal(a["tokens"].numpy(), b["tokens"].numpy())
    np.testing.assert_array_equal(a["geo_block"].numpy(),
                                  b["geo_block"].numpy())
    assert (a["geo_block"].numpy() >= 0).mean() > 0.5
    assert src.engine.strategy == "fast"
    assert src.engine.cfg.mode == "approx"
    assert src.engine.device.type == "cpu"


def test_geo_enriched_rejects_a_simple_only_engine(synth_small):
    eng = GeoEngine.build(synth_small.census, "simple", device="cpu")
    src = make_source(get_reduced_config(ARCH),
                      ShapeConfig("t", 16, 2, "train"), geo=eng,
                      device="cpu")
    with pytest.raises(ValueError, match="cell index"):
        src.batch_at(0)


# -- GeoEngine's legacy index keywords ----------------------------------------

def test_legacy_index_keywords_match_repro(synth_small, points_small,
                                           indices):
    """``fast_index=`` / ``simple_index=`` (with ``census=`` and
    ``covering=``) fold into a GeoIndexSet on the index's device and
    assign as ``repro``'s legacy engines do."""
    census = synth_small.census
    j_idx, t_idx = indices
    xy = points_small[0]
    cfg = dict(cap_boundary=1.0, max_level=8)
    t_fast = GeoEngine("fast", EngineConfig(**cfg), fast_index=t_idx)
    j_fast = JEngine("fast", JConfig(backend="ref", **cfg),
                     fast_index=j_idx)
    assert t_fast.indices.device == t_idx.device
    assert t_fast.indices.capabilities() == j_fast.indices.capabilities()
    t_simple = GeoEngine("simple", EngineConfig(),
                         simple_index=SimpleIndex.from_census(
                             census, device="cpu"), census=census)
    j_simple = JEngine("simple", JConfig(backend="ref"),
                       simple_index=JSimpleIndex.from_census(census),
                       census=census)
    assert t_simple.device.type == "cpu" and t_simple.census is census
    for t, j in ((t_fast, j_fast), (t_simple, j_simple)):
        rt, rj = t.assign(xy), j.assign(jnp.asarray(xy))
        for f in ("state", "county", "block"):
            np.testing.assert_array_equal(getattr(rt, f).numpy(),
                                          np.asarray(getattr(rj, f)))
        assert rt.stats.as_dict() == rj.stats.as_dict()
        assert without_covering(t) == j.explain()
    with pytest.raises(ValueError, match="fast_index"):
        GeoEngine("fast", EngineConfig(), census=census)

"""Exact ``fast`` on a card through the one-pass cascade kernel: the
planner's CUDA rule (``core/plan.py``) and the edge pool packed on the
device of the edges it is given (``kernels/gather_pip.py``).

* An engine that ``GeoEngine.from_index_set(..., "auto")`` plans for a
  card runs ``fast`` with ``fused="onepass"``; its ids and its ``n_need``
  / ``n_pip`` equal those of an engine pinned to ``fast`` with
  ``fused=False`` (the gathered path) on the same batch, and its
  ``bbox_skips`` counter rides in ``GeoStats.extra``.  On the CPU the
  rule is asked for a card's plan, so the twins run the same route.
* The pool packed on the card equals the pool packed on the CPU, array
  for array.

Map: four states of the synthetic census; points from its ground-truth
sampler, kept 3 x the warp's sagitta bound off every block side, so the
sampler's ids are the answer too.  Tolerance: exact equality (integer
ids and counts, copied floats).  The cases marked ``cuda`` skip here.
This file imports no JAX, so it runs on the card as it is:

    PYTHONPATH=src python -m pytest -q tests/test_torch_onepass_route.py -m cuda
"""
import numpy as np
import pytest
import torch

from repro_torch.core import plan as t_plan
from repro_torch.core.artifact import GeoIndexSet
from repro_torch.core.engine import EngineConfig, GeoEngine
from repro_torch.core.synth import build_synth_census
from repro_torch.kernels import ops

NEEDS_CUDA = "needs a CUDA device; the H100 runs it"
BES = (16, 64, 256)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CUDA)
    return torch.device("cuda")


@pytest.fixture(scope="module")
def four_states():
    sc = build_synth_census(seed=3, n_states=4, counties_per_state=4,
                            blocks_per_county=16)
    xy, bid, cid, sid = sc.sample_points(np.random.default_rng(5), 1 << 13,
                                         margin=0.0)
    return sc, xy, np.stack([sid, cid, bid])


def _route_pair(sc, device):
    """(the auto-planned engine, the engine pinned to the gathered path),
    each over its own artifact on ``device``."""
    def index_set():
        return GeoIndexSet(census=sc.census, device=device)
    auto = GeoEngine.from_index_set(index_set(), "auto",
                                    EngineConfig(mode="exact"))
    pinned = GeoEngine.from_index_set(index_set(), "fast",
                                      EngineConfig(mode="exact",
                                                   fused=False))
    return auto, pinned


def _check_route(auto, pinned, xy, want):
    plan = auto.explain()
    assert (auto.strategy, plan["strategy"], plan["fused"]) == \
        ("fast", "fast", "onepass")
    assert plan["reasons"][-1] == t_plan.ONEPASS_CUDA_REASON
    assert auto.fast_index.edge_pool is not None
    assert pinned.explain()["fused"] is False
    pts = torch.as_tensor(xy, device=auto.device)
    got, ref = auto.assign(pts), pinned.assign(pts)
    for a, b in zip((got.state, got.county, got.block),
                    (ref.state, ref.county, ref.block)):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(
        torch.stack([got.state, got.county, got.block]).cpu().numpy(), want)
    assert int(ref.stats.overflow) == 0 == int(got.stats.overflow)
    assert int(got.stats.n_need) == int(ref.stats.n_need) > 0
    assert int(got.stats.n_pip) == int(ref.stats.n_pip) > 0
    assert "bbox_skips" in got.stats.extra


def test_route_on_cpu_twins(four_states, monkeypatch):
    """The rule's route, planned for a card and run by the twins."""
    sc, xy, want = four_states
    monkeypatch.setattr(t_plan, "device_kind_of", lambda device=None:
                        "cuda")
    _check_route(*_route_pair(sc, "cpu"), xy, want)


@pytest.mark.cuda
def test_route_on_card(cuda_device, four_states):
    sc, xy, want = four_states
    auto, pinned = _route_pair(sc, cuda_device)
    assert auto.fast_index.edge_pool.blocks.device.type == "cuda"
    _check_route(auto, pinned, xy, want)


def _tables(sc, be):
    rng = np.random.default_rng(be)
    dense = rng.uniform(-1.0, 1.0, (12, 3 * be + 5, 4)).astype(np.float32)
    dead = rng.random(dense.shape[:2]) < 0.3
    dead[3] = True                                   # no live edge
    dense[dead, 2:] = dense[dead, :2]
    return {"census": ops.edges_from_soup_np(sc.census.blocks.verts),
            "random": dense, "empty": np.zeros((0, 4, 4), np.float32)}


@pytest.mark.cuda
@pytest.mark.parametrize("be", BES)
def test_card_packed_pool_equals_cpu_packed(cuda_device, four_states, be):
    sc = four_states[0]
    for name, dense in _tables(sc, be).items():
        cpu = ops.build_edge_pool(torch.from_numpy(dense), be=be)
        card = ops.build_edge_pool(torch.from_numpy(dense).to(cuda_device),
                                   be=be)
        assert card.blocks.device.type == "cuda", name
        for f in ("blocks", "first", "count", "live"):
            assert torch.equal(getattr(card, f).cpu(), getattr(cpu, f)), \
                (name, f)
        assert (card.max_blocks, card.be) == (cpu.max_blocks, cpu.be), name

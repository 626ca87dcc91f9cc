"""GeoEngine: plan-and-execute facade over registered mapping strategies
(port of src/repro/core/engine.py; DESIGN.md §3, §11).

    eng = GeoEngine.build(census)     # strategy "simple", index on cuda
    res = eng.assign(points)          # AssignResult of [N] i32 tensors
    res.block                         # block ids (-1 = off-map)
    eng.explain()                     # {"strategy": ..., "reasons": [...]}

The index and every assigned batch live on ``device`` — "cuda" unless
the caller passes ``device="cpu"`` (the tests do), and there is no
fallback to the CPU when no card is found.  On the card every strategy
runs the hand-written CUDA kernels:

  * ``simple`` (the paper's §III cascade): ``bbox_mask`` at the state
    level, ``bbox_select_children`` at the county and block levels, and
    candidate PIP per level;
  * ``fast`` exact (§IV): candidate PIP on boundary cells;
  * ``hybrid``: the cell lookup, then the ``simple`` cascade on the
    boundary points;
  * ``fast_onepass``: the one-pass cascade kernel;
  * ``assign_sharded(points, mesh)``: the cell table Morton-sharded over
    the mesh's "model" axis (a ``launch.mesh.Mesh`` over
    ``torch.distributed``) through the registered ``sharded`` plugin,
    points routed to their owning shard by the MoE dispatch primitive
    (distributed/dispatch.py); its PIP runs the same two kernels.

Candidate PIP runs the gathered PIP kernel with ``fused=False`` and the
candidate PIP kernel over the edge pools with ``fused=True``; the
results are identical.  On a card, ``strategy="auto"`` plans exact
``fast`` on the one-pass kernel (``core/plan.py``'s CUDA rule), and that
engine's ``assign_sharded`` keeps the gathered path.  Capability gaps
surface as ValueError at construction, never at the first assign.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import fast as fast_mod
from repro_torch.core import plan as plan_mod
from repro_torch.core import strategies as _strategies  # noqa: F401  (registers
#                                                         the plugins)
from repro_torch.core.artifact import GeoIndexSet
from repro_torch.core.fast import FastConfig
from repro_torch.core.geometry import CensusMap
from repro_torch.core.registry import available_strategies, get_strategy
from repro_torch.core.resolve import AssignResult
from repro_torch.core.simple import SimpleConfig
from repro_torch.kernels import ops
from repro_torch.obs.profile import span

# Names an explicit ``GeoEngine.build(strategy=...)`` accepts ("auto"
# additionally asks the planner).
STRATEGIES = ("simple", "fast", "fast_onepass", "hybrid")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static engine knobs (the JAX package's).  The per-strategy configs
    derive from this one."""

    backend: str | None = None   # kernel backend override
    k_cand: int = 4              # cascade PIP candidates per level
    cap_state: float = 0.25      # cascade compaction fractions
    cap_county: float = 0.5
    cap_block: float = 0.5
    mode: str = "exact"          # fast boundary handling: exact | approx
    cap_boundary: float = 0.25   # fast/hybrid boundary compaction fraction
    max_level: int | None = None  # covering depth; None: the
    #                              artifact's, else the block count's
    #                              (cells.covering_level)
    gbits: int = 4               # top-grid bits
    max_cand: int = 8            # boundary candidate list width
    cap_shard: float = 2.0       # sharded assign: capacity factor vs N/S
    fused: bool | str = False    # False | True | "onepass" (see module
    #                              doc); strategies other than fast take
    #                              "onepass" as True

    def simple_cfg(self) -> SimpleConfig:
        return SimpleConfig(k_cand=self.k_cand, cap_state=self.cap_state,
                            cap_county=self.cap_county,
                            cap_block=self.cap_block, backend=self.backend,
                            fused=bool(self.fused))

    def fast_cfg(self) -> FastConfig:
        return FastConfig(mode=self.mode, cap_boundary=self.cap_boundary,
                          backend=self.backend, fused=self.fused)

    def hybrid_cascade_cfg(self) -> SimpleConfig:
        # The cascade only sees the compacted boundary buffer, so it runs
        # at full capacity: the buffer is the capacity limit.
        return SimpleConfig(k_cand=self.k_cand, cap_state=1.0,
                            cap_county=1.0, cap_block=1.0,
                            backend=self.backend, fused=bool(self.fused))


class GeoEngine:
    """Facade: plan once, build once, assign many (see module docstring)."""

    def __init__(self, strategy: str, cfg: Optional[EngineConfig] = None, *,
                 indices: Optional[GeoIndexSet] = None,
                 simple_index=None, fast_index=None, covering=None,
                 census: Optional[CensusMap] = None,
                 plan: Optional[plan_mod.GeoPlan] = None):
        """Wrap already-built indices.  ``indices`` is the artifact; the
        ``simple_index`` / ``fast_index`` / ``covering`` / ``census``
        keywords are the legacy spelling, folded into one on the given
        index's device ("cuda" when no index is given).  Capability
        validation happens HERE: a misconfigured engine never
        constructs."""
        self.cfg = cfg or EngineConfig()
        self._impl = get_strategy(strategy)
        self.strategy = strategy
        if indices is None:
            built = fast_index if fast_index is not None else simple_index
            indices = GeoIndexSet(
                census=census, covering=covering, simple=simple_index,
                fast=fast_index, max_level=self.cfg.max_level,
                gbits=self.cfg.gbits, max_cand=self.cfg.max_cand,
                device=built.device if built is not None else "cuda")
        self.indices = indices
        if self.cfg.max_level is None and indices.max_level is not None:
            self.cfg = dataclasses.replace(self.cfg,
                                           max_level=indices.max_level)
        self._impl.validate(indices, self.cfg)
        self.plan = plan if plan is not None else plan_mod.explicit_plan(
            strategy, self.cfg, plan_mod.device_kind_of(indices.device))

    @classmethod
    def build(cls, census: CensusMap, strategy: str = "simple",
              cfg: Optional[EngineConfig] = None, covering=None, *,
              device="cuda") -> "GeoEngine":
        """Build the indices ``strategy`` needs from a host census, on
        ``device``.  ``strategy="auto"`` builds the covering, asks the
        planner, and builds to its plan."""
        cfg = cfg or EngineConfig()
        indices = GeoIndexSet(census=census, covering=covering,
                              max_level=cfg.max_level, gbits=cfg.gbits,
                              max_cand=cfg.max_cand, device=device)
        plan = None
        if strategy == "auto":
            indices.ensure("covering")
            plan = plan_mod.plan_for(
                cfg, covering=indices.covering, tuning=indices.tuning,
                device_kind=plan_mod.device_kind_of(device))
            cfg = plan.apply(cfg)
            strategy = plan.strategy
        return cls._ensured(strategy, cfg, indices, plan)

    @classmethod
    def from_index_set(cls, indices: GeoIndexSet, strategy: str = "auto",
                       cfg: Optional[EngineConfig] = None) -> "GeoEngine":
        """Build over an existing artifact; its build parameters
        (max_level / gbits / max_cand) override the config's."""
        cfg = dataclasses.replace(cfg or EngineConfig(),
                                  max_level=indices.max_level,
                                  gbits=indices.gbits,
                                  max_cand=indices.max_cand)
        plan = None
        if strategy == "auto":
            if indices.census is not None:
                indices.ensure("covering")
            plan = plan_mod.plan_for(
                cfg, covering=indices.covering,
                capabilities=indices.capabilities(), tuning=indices.tuning,
                device_kind=plan_mod.device_kind_of(indices.device))
            cfg = plan.apply(cfg)
            strategy = plan.strategy
        if indices.census is None:
            return cls(strategy, cfg, indices=indices, plan=plan)
        return cls._ensured(strategy, cfg, indices, plan)

    @classmethod
    def _ensured(cls, strategy, cfg, indices, plan) -> "GeoEngine":
        impl = get_strategy(strategy)
        for comp in impl.required_components(cfg):
            indices.ensure(comp)
        for comp in impl.pool_components(cfg):
            indices.ensure(comp, pool=True)
        return cls(strategy, cfg, indices=indices, plan=plan)

    # -- index views ---------------------------------------------------------

    @property
    def device(self) -> torch.device:
        return torch.device(self.indices.device)

    @property
    def simple_index(self):
        return self.indices.simple

    @property
    def fast_index(self):
        return self.indices.fast

    @property
    def covering(self):
        return self.indices.covering

    @property
    def census(self):
        return self.indices.census

    # -- planning introspection ---------------------------------------------

    def explain(self, n_points: Optional[int] = None) -> dict:
        """The engine's plan as a JSON-ready dict; with a batch-size hint,
        what the planner would choose for that batch against this
        engine's built capabilities.  Its ``"covering"`` is the
        artifact's ``covering_facts()`` (level, cells, boundary cells,
        bytes, ``search_iters``), which the JAX package does not
        report."""
        if n_points is None:
            plan = self.plan
        else:
            plan = plan_mod.plan_for(
                self.cfg, covering=self.indices.covering,
                capabilities=self.indices.capabilities(),
                n_points=n_points, tuning=self.indices.tuning,
                device_kind=plan_mod.device_kind_of(self.device))
        return {**plan.as_dict(), "covering": self.indices.covering_facts()}

    # -- assign ---------------------------------------------------------------

    def _points(self, points) -> torch.Tensor:
        return torch.as_tensor(points, dtype=torch.float32,
                               device=self.device)

    def assign(self, points) -> AssignResult:
        """Map [N, 2] (lon, lat) points (array or tensor; moved to the
        engine's device) -> AssignResult of [N] i32 id tensors (-1 = not
        on the map) and a GeoStats.  Under a capturing profiler the call
        is the ``geo.assign`` span (``obs.profile.span``), its phases
        nested inside."""
        with span("geo.assign"):
            return self._impl.assign(self.indices, self._points(points),
                                     self.cfg)

    def assign_padded(self, points, n_valid) -> AssignResult:
        """Shape-stable assign over a padded batch: rows >= ``n_valid``
        are rewritten to ``ops.FAR`` (outside every extent, bbox and
        polygon), so they enter no need mask, compaction or PIP call,
        the GeoStats counters equal an unpadded assign of the valid
        prefix, and pad rows come back -1 in all three id tensors."""
        if not self._impl.caps.supports_padded:
            raise ValueError(f"strategy {self.strategy!r} does not "
                             f"support padded batches")
        pts = self._points(points)
        valid = torch.arange(pts.shape[0], device=self.device) < n_valid
        masked = torch.where(valid[:, None], pts, ops.FAR)
        res = self.assign(masked)
        return AssignResult(torch.where(valid, res.state, -1),
                            torch.where(valid, res.county, -1),
                            torch.where(valid, res.block, -1), res.stats)

    # -- index / extent handles ---------------------------------------------

    def extent_quant(self) -> tuple[np.ndarray, int]:
        """(quant [4] f32 = (x0, y0, sx, sy), max_level): the fast
        index's when there is one, else derived from the census extent
        with the formula ``FastIndex.from_covering`` uses."""
        if self.fast_index is not None:
            return (self.fast_index.quant.cpu().numpy(),
                    self.fast_index.max_level)
        if self.census is None:
            raise ValueError("extent_quant needs a fast index or a census "
                             "(engine built via GeoEngine.build)")
        return (fast_mod.quant_for_extent(self.census.extent,
                                          self.cfg.max_level),
                self.cfg.max_level)

    def extent_contains(self, points) -> np.ndarray:
        """[N] bool (host numpy) — True where the point lies inside this
        engine's map extent (``fast.np_extent_mask``)."""
        quant, max_level = self.extent_quant()
        return fast_mod.np_extent_mask(quant, max_level, points)

    def host_parents(self) -> tuple[np.ndarray, np.ndarray]:
        """(block_parent [Nb], county_parent [Nc]) as host arrays, from
        the fast index or else the simple one."""
        index = self.fast_index if self.fast_index is not None \
            else self.simple_index
        return (index.block_parent.cpu().numpy(),
                index.county_parent.cpu().numpy())

    def assign_sharded(self, points, mesh) -> AssignResult:
        """Sharded lookup over ``mesh``'s "model" axis (every rank passes
        the same whole batch and gets the whole result), routed through
        the registered "sharded" plugin, or the engine's own strategy if
        it declares ``supports_sharded`` — see core/strategies.py for
        capacity and drop accounting."""
        impl = self._impl if self._impl.caps.supports_sharded \
            else get_strategy("sharded")
        cfg = self.cfg
        if self.plan.device_rule:
            # The sharded lookup has no one-pass route: it keeps the
            # gathered path the config asked for.
            cfg = dataclasses.replace(cfg, fused=False)
        return impl.assign_sharded(self.indices, self._points(points), mesh,
                                   cfg)


__all__ = ["EngineConfig", "GeoEngine", "GeoIndexSet", "STRATEGIES",
           "available_strategies"]

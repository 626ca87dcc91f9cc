"""Strategy protocol + registry: the engine's pluggable dispatch surface
(port of src/repro/core/registry.py; DESIGN.md §11).

A strategy is an object implementing ``Strategy``, registered under a
name with declared capability flags; the engine resolves names through
``get_strategy`` only.  Capability flags answer, before any point is
assigned:

  * ``needs``            — which ``GeoIndexSet`` components it reads;
  * ``needs_edge_pool``  — whether ``cfg.fused`` requires edge pools;
  * ``supports_sharded`` — implements ``assign_sharded``;
  * ``supports_padded``  — safe under ``GeoEngine.assign_padded``.

``Strategy.validate`` turns them into build-time errors.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

COMPONENTS = ("simple", "fast", "covering")


@dataclasses.dataclass(frozen=True)
class StrategyCaps:
    """Declared capabilities of a registered strategy (see module doc)."""

    needs: Tuple[str, ...] = ()
    needs_edge_pool: bool = False
    supports_sharded: bool = False
    supports_padded: bool = True


class Strategy:
    """Base class for registered strategies (``name`` and ``caps`` are
    attached by ``register_strategy``)."""

    name: str = "?"
    caps: StrategyCaps = StrategyCaps()

    def required_components(self, cfg) -> Tuple[str, ...]:
        """GeoIndexSet components this strategy reads under ``cfg``."""
        return self.caps.needs

    def pool_components(self, cfg) -> Tuple[str, ...]:
        """Components whose edge pools ``cfg`` requires (default: every
        index component in ``needs`` when ``cfg.fused``)."""
        if not (self.caps.needs_edge_pool and getattr(cfg, "fused", False)):
            return ()
        return tuple(c for c in self.caps.needs if c != "covering")

    def validate(self, indices, cfg) -> None:
        """Raise ValueError if ``indices`` lacks a component or pool this
        strategy needs under ``cfg`` — at engine construction, never at
        the first ``assign``.  A strategy with no single-mesh ``assign``
        (the sharded-only plugin) is rejected here too."""
        if type(self).assign is Strategy.assign:
            kind = ("sharded-only" if self.caps.supports_sharded
                    else "abstract")
            raise ValueError(
                f"strategy {self.name!r} implements no single-mesh "
                f"assign ({kind}) — build the engine with an "
                f"assign-capable strategy; engine.assign_sharded routes "
                f"to sharded plugins by itself")
        caps = indices.capabilities()
        for comp in self.required_components(cfg):
            if not caps.get(comp, False):
                raise ValueError(
                    f"strategy {self.name!r} needs a {comp}_index"
                    if comp != "covering" else
                    f"strategy {self.name!r} needs a cell covering "
                    f"(build the engine from a census)")
        for comp in self.pool_components(cfg):
            if not caps.get(f"{comp}_pool", False):
                raise ValueError(
                    f"strategy {self.name!r} with fused=True needs the "
                    f"{comp} index built with_pool=True — rebuild via "
                    f"GeoIndexSet/GeoEngine.build, or drop fused")

    def assign(self, indices, points, cfg):
        """[N, 2] points -> AssignResult against ``indices``."""
        raise NotImplementedError(
            f"strategy {self.name!r} does not implement single-mesh "
            f"assign")

    def assign_sharded(self, indices, points, mesh, cfg):
        """Sharded lookup over ``mesh`` (only when supports_sharded)."""
        raise NotImplementedError(
            f"strategy {self.name!r} does not support sharded assign")


_REGISTRY: dict[str, Strategy] = {}


def register_strategy(name: str, *, needs: Tuple[str, ...] = (),
                      needs_edge_pool: bool = False,
                      supports_sharded: bool = False,
                      supports_padded: bool = True):
    """Class decorator: instantiate and register ``cls`` under ``name``
    (last registration wins)."""
    unknown = set(needs) - set(COMPONENTS)
    if unknown:
        raise ValueError(f"unknown index components {sorted(unknown)}; "
                         f"expected a subset of {COMPONENTS}")

    def deco(cls):
        inst = cls()
        inst.name = name
        inst.caps = StrategyCaps(needs=tuple(needs),
                                 needs_edge_pool=needs_edge_pool,
                                 supports_sharded=supports_sharded,
                                 supports_padded=supports_padded)
        _REGISTRY[name] = inst
        return cls

    return deco


def get_strategy(name: str) -> Strategy:
    """Resolve a registered strategy by name (ValueError on unknown)."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown strategy {name!r}; expected one of "
                         f"{available_strategies()} (or 'auto')") from None


def available_strategies() -> Tuple[str, ...]:
    """Registered strategy names, registration order."""
    return tuple(_REGISTRY)


def sharded_strategies() -> Tuple[str, ...]:
    """Names of strategies that implement ``assign_sharded``."""
    return tuple(n for n, s in _REGISTRY.items()
                 if s.caps.supports_sharded)

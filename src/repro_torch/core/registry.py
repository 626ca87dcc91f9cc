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

# Strategies of the JAX package that this port does not run yet, with
# the ROADMAP slice that brings each.
NOT_PORTED = {
    "sharded": "the distributed slice (ROADMAP queue 1, item 7)",
}


def not_ported(name: str) -> NotImplementedError:
    return NotImplementedError(
        f"strategy {name!r} is not ported to repro_torch yet; it comes "
        f"with {NOT_PORTED[name]}")


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
        the first ``assign``."""
        if type(self).assign is Strategy.assign:
            raise ValueError(
                f"strategy {self.name!r} implements no single-mesh "
                f"assign — build the engine with an assign-capable "
                f"strategy")
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
    """Resolve a registered strategy by name: NotImplementedError for a
    JAX-package strategy not ported yet, ValueError for an unknown one."""
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name in NOT_PORTED:
        raise not_ported(name)
    raise ValueError(f"unknown strategy {name!r}; expected one of "
                     f"{available_strategies()} (or 'auto')")


def available_strategies() -> Tuple[str, ...]:
    """Registered strategy names, registration order."""
    return tuple(_REGISTRY)

"""GeoIndexSet: the in-memory index artifact behind every strategy (port
of src/repro/core/artifact.py; DESIGN.md §11).

One object owns the host census and cell covering and the device indices
derived from them (``SimpleIndex`` for the cascade, ``FastIndex`` for the
cell lookup, each with or without its edge pools), all on one
``device``.  Components build lazily through ``ensure``: strategies
declare what they need and the engine ensures exactly that.
``capabilities()`` is the snapshot the registry's build-time validation
and the planner read.  ``save``/``load`` (the npz + manifest format) come
with a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from repro_torch.core.cells import CellCovering, build_cell_covering
from repro_torch.core.fast import FastIndex
from repro_torch.core.geometry import CensusMap
from repro_torch.core.simple import SimpleIndex
from repro_torch.kernels import ops


@dataclasses.dataclass
class GeoIndexSet:
    """Lazily built index artifact (see module docstring).

    ``max_level`` / ``gbits`` / ``max_cand`` are the covering/index build
    parameters; ``device`` is where the device index lives ("cuda"
    unless the caller asks for "cpu").
    """

    census: Optional[CensusMap] = None
    covering: Optional[CellCovering] = None
    simple: Optional[SimpleIndex] = None
    fast: Optional[FastIndex] = None
    max_level: int = 9
    gbits: int = 4
    max_cand: int = 8
    # Autotune record (winner, be, device_kind, ...), as in the JAX
    # package's manifest; the planner reads it.
    tuning: Dict[str, Any] = dataclasses.field(default_factory=dict)
    device: Any = "cuda"

    @classmethod
    def build(cls, census: CensusMap, components=(), pools=(), *,
              max_level: int = 9, gbits: int = 4, max_cand: int = 8,
              covering: Optional[CellCovering] = None,
              device="cuda") -> "GeoIndexSet":
        """Build the requested ``components`` ("simple" | "fast" |
        "covering") from a host census on ``device``; ``pools`` names the
        components that also need their edge pools (the fused path)."""
        self = cls(census=census, covering=covering, max_level=max_level,
                   gbits=gbits, max_cand=max_cand, device=device)
        for comp in components:
            self.ensure(comp)
        for comp in pools:
            self.ensure(comp, pool=True)
        return self

    def ensure(self, component: str, pool: bool = False) -> None:
        """Build ``component`` ("covering" | "simple" | "fast") if
        missing, and its edge pools when ``pool``.  Pools attach to a
        built index in place, packed from the same edge arrays at
        ``pool_be()``."""
        if component == "covering":
            if self.covering is None:
                self._need_census("the cell covering")
                self.covering = build_cell_covering(
                    self.census, max_level=self.max_level,
                    max_cand=self.max_cand)
        elif component == "fast":
            if self.fast is None:
                self._need_census("the fast (cell) index")
                self.ensure("covering")
                self.fast = FastIndex.from_covering(
                    self.covering, self.census, gbits=self.gbits,
                    with_pool=False, device=self.device)
            if pool and self.fast.edge_pool is None:
                self.fast = dataclasses.replace(
                    self.fast,
                    edge_pool=ops.build_edge_pool(
                        self.fast.block_edges.cpu().numpy(),
                        be=self.pool_be(), device=self.device))
        elif component == "simple":
            if self.simple is None:
                self._need_census("the simple (cascade) index")
                self.simple = SimpleIndex.from_census(self.census,
                                                      device=self.device)
            if pool and self.simple.state_pool is None:
                self.simple = self.simple.with_pools(self.pool_be())
        else:
            raise ValueError(f"unknown index component {component!r}; "
                             f"expected 'simple', 'fast', or 'covering'")

    def _need_census(self, what: str) -> None:
        if self.census is None:
            raise ValueError(f"building {what} needs a census")

    def pool_be(self) -> int:
        """Edge-pool block size: the autotuned value when one is
        recorded, ``ops.DEF_BE`` otherwise."""
        return int(self.tuning.get("be") or 0) or ops.DEF_BE

    def memory_footprint(self) -> Dict[str, int]:
        """Bytes of the built device index and its pool (plus the pool's
        block size); a lazy artifact reports 0s."""
        fp = {"pool_be": self.pool_be(), "edge_pool_bytes": 0,
              "edge_pool_blocks": 0, "edge_pool_max_blocks": 0,
              "index_bytes": 0}
        if self.fast is not None:
            for leaf in (self.fast.cell_lo, self.fast.cell_hi,
                         self.fast.cell_val, self.fast.top_start,
                         self.fast.cand, self.fast.block_bbox):
                if leaf is not None:
                    fp["index_bytes"] += leaf.numel() * leaf.element_size()
            pool = self.fast.edge_pool
            if pool is not None:
                fp["edge_pool_bytes"] = pool.nbytes()
                fp["edge_pool_blocks"] = int(pool.blocks.shape[0])
                fp["edge_pool_max_blocks"] = int(pool.max_blocks)
        return fp

    def capabilities(self) -> Dict[str, Any]:
        """What is built right now (keys as in the JAX package: census,
        covering, simple, fast, simple_pool, fast_pool, sharded)."""
        return {
            "census": self.census is not None,
            "covering": self.covering is not None,
            "simple": self.simple is not None,
            "fast": self.fast is not None,
            "simple_pool": (self.simple is not None
                            and self.simple.state_pool is not None),
            "fast_pool": (self.fast is not None
                          and self.fast.edge_pool is not None),
            "sharded": [],
        }

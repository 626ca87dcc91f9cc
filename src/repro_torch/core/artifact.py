"""GeoIndexSet: the index artifact behind every strategy (port of
src/repro/core/artifact.py; DESIGN.md §11).

One object owns the host census and cell covering and the device indices
derived from them (``SimpleIndex`` for the cascade, ``FastIndex`` for the
cell lookup, each with or without its edge pools, and the Morton-sharded
``ShardedFastIndex`` per shard count), all on one ``device``.
Components build lazily through ``ensure``: strategies declare what they
need and the engine ensures exactly that.
``capabilities()`` is the snapshot the registry's build-time validation
and the planner read.

**Persistence** (``save``/``load``): the artifact writes its host
primitives (the census polygon soups and the covering arrays) as one
npz beside a JSON manifest, in the JAX package's format: the same npz
keys and dtypes, the same manifest keys, so an artifact saved by either
package loads in the other.  The port writes the npz uncompressed (the
JAX package compresses it; ``np.load`` reads either): at the paper's
220,864 blocks the covering alone is ~270 MB, and inflating it would
cost every cold start seconds.  Device indices are not stored:
they are deterministic functions of the saved arrays, rebuilt by
``ensure`` on the loading ``device``.  A cold start skips the covering
build, the one build step that scales with the map's complexity.

    idx = GeoIndexSet.build(census, components=("fast",), gbits=4)
    idx.save("artifacts/national")
    ...
    idx = GeoIndexSet.load("artifacts/national", device="cuda")
    eng = GeoEngine.from_index_set(idx, strategy="auto")
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional

import numpy as np

from repro_torch.core.cells import (CellCovering, build_cell_covering,
                                   covering_level)
from repro_torch.core.distributed import ShardedFastIndex, shard_covering
from repro_torch.core.fast import FastIndex
from repro_torch.core.geometry import CensusMap, PolygonSoup
from repro_torch.core.simple import SimpleIndex
from repro_torch.kernels import ops

# v2 adds the ``tuning`` manifest block (the autotune record); v1
# artifacts load with empty tuning.
SCHEMA_VERSION = 2
ACCEPTED_SCHEMA_VERSIONS = (1, 2)
MANIFEST_NAME = "manifest.json"
ARRAYS_NAME = "arrays.npz"
FORMAT_NAME = "geo-index-set"

_SOUP_FIELDS = ("verts", "n_verts", "bbox", "parent", "fips")
_COVER_FIELDS = ("lo", "hi", "val", "level", "cand")
_LEVELS = ("states", "counties", "blocks")
# What ``covering_facts`` reports (in ``memory_footprint`` and
# ``GeoEngine.explain``).
COVERING_KEYS = ("covering_level", "covering_cells",
                 "covering_boundary_cells", "covering_bytes",
                 "search_iters")


@dataclasses.dataclass
class GeoIndexSet:
    """Lazily built index artifact (see module docstring).

    ``max_level`` / ``gbits`` / ``max_cand`` are the covering/index build
    parameters; ``device`` is where the device index lives ("cuda"
    unless the caller asks for "cpu").  ``max_level`` None takes the
    given covering's level, else the one ``cells.covering_level`` gives
    the census's block count (9 up to 4,096 blocks, where the JAX
    package always takes 9).
    """

    census: Optional[CensusMap] = None
    covering: Optional[CellCovering] = None
    simple: Optional[SimpleIndex] = None
    fast: Optional[FastIndex] = None
    # Morton-sharded indices by shard count (built on demand by
    # ``sharded_index``; never saved).
    sharded: Dict[int, ShardedFastIndex] = dataclasses.field(
        default_factory=dict)
    max_level: Optional[int] = None
    gbits: int = 4
    max_cand: int = 8
    # Autotune record, persisted in the manifest (schema v2) so a
    # reloaded artifact plans from measurements.  Keys (all optional):
    # "winner", "be", "device_kind", "pts_per_sec", "roofline_fraction",
    # "recorded".
    tuning: Dict[str, Any] = dataclasses.field(default_factory=dict)
    device: Any = "cuda"

    def __post_init__(self):
        if self.max_level is None:
            if self.covering is not None:
                self.max_level = int(self.covering.max_level)
            elif self.census is not None:
                self.max_level = covering_level(self.census.blocks.n_poly)

    @classmethod
    def build(cls, census: CensusMap, components=(), pools=(), *,
              max_level: Optional[int] = None, gbits: int = 4,
              max_cand: int = 8,
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
        built index in place, packed from its edge tables on its own
        device at ``pool_be()``."""
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
                    edge_pool=ops.build_edge_pool(self.fast.block_edges,
                                                  be=self.pool_be()))
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

    def sharded_index(self, n_shards: int,
                      with_pool: bool = False) -> ShardedFastIndex:
        """The Morton-sharded index for ``n_shards``, built once per shard
        count (pool attached on demand at ``pool_be()``, like
        ``ensure``)."""
        if n_shards not in self.sharded:
            if self.covering is None or self.census is None:
                raise ValueError("assign_sharded needs the engine built "
                                 "from a census with a cell covering "
                                 "(strategy 'fast' or 'hybrid')")
            self.sharded[n_shards] = shard_covering(
                self.covering, self.census, n_shards, with_pool=False,
                device=self.device)
        sidx = self.sharded[n_shards]
        if with_pool and sidx.edge_pool is None:
            self.sharded[n_shards] = dataclasses.replace(
                sidx, edge_pool=ops.build_edge_pool(sidx.block_edges,
                                                    be=self.pool_be()))
        return self.sharded[n_shards]

    # -- autotune record ----------------------------------------------------

    def pool_be(self) -> int:
        """Edge-pool block size: the autotuned value when one is
        recorded, ``ops.DEF_BE`` otherwise."""
        return int(self.tuning.get("be") or 0) or ops.DEF_BE

    def record_tuning(self, tuning: Dict[str, Any]) -> None:
        """Merge an autotune result into the artifact (persisted by
        ``save``).  When the recorded ``be`` changes the pool block size,
        the built pools are dropped so the next ``ensure(..., pool=True)``
        repacks at the tuned size."""
        old_be = self.pool_be()
        self.tuning = {**self.tuning, **tuning}
        if self.pool_be() != old_be:
            if self.fast is not None and self.fast.edge_pool is not None:
                self.fast = dataclasses.replace(self.fast, edge_pool=None)
            if self.simple is not None \
                    and self.simple.state_pool is not None:
                self.simple = dataclasses.replace(
                    self.simple, state_pool=None, county_pool=None,
                    block_pool=None)
            for n, sidx in list(self.sharded.items()):
                if sidx.edge_pool is not None:
                    self.sharded[n] = dataclasses.replace(sidx,
                                                          edge_pool=None)

    def memory_footprint(self) -> Dict[str, int]:
        """Bytes of the built device index and its pool (plus the pool's
        block size), counted as the JAX package counts them: the pool's
        ``blocks``, ``first`` and ``count`` (``EdgePool.nbytes()`` also
        counts the port's ``live``).  A lazy artifact reports 0s.

        The port adds the covering's facts (``COVERING_KEYS``, which the
        JAX package does not report): its level, cells, boundary cells
        and host bytes, and the fast index's ``search_iters``."""
        fp = {"pool_be": self.pool_be(), "edge_pool_bytes": 0,
              "edge_pool_blocks": 0, "edge_pool_max_blocks": 0,
              "index_bytes": 0, **self.covering_facts()}
        if self.fast is not None:
            for leaf in (self.fast.cell_lo, self.fast.cell_hi,
                         self.fast.cell_val, self.fast.top_start,
                         self.fast.cand, self.fast.block_bbox):
                if leaf is not None:
                    fp["index_bytes"] += leaf.numel() * leaf.element_size()
            pool = self.fast.edge_pool
            if pool is not None:
                fp["edge_pool_bytes"] = sum(
                    t.numel() * t.element_size()
                    for t in (pool.blocks, pool.first, pool.count))
                fp["edge_pool_blocks"] = int(pool.blocks.shape[0])
                fp["edge_pool_max_blocks"] = int(pool.max_blocks)
        return fp

    def covering_facts(self) -> Dict[str, int]:
        """``COVERING_KEYS``: the covering's level, cells, boundary cells
        and host bytes (0s before it is built) and the fast index's
        ``search_iters`` (0 before that is built)."""
        cov = self.covering
        return {
            "covering_level": 0 if cov is None else int(cov.max_level),
            "covering_cells": 0 if cov is None else int(len(cov.lo)),
            "covering_boundary_cells": (0 if cov is None
                                        else int(cov.n_boundary)),
            "covering_bytes": 0 if cov is None else int(cov.nbytes()),
            "search_iters": (0 if self.fast is None
                             else int(self.fast.search_iters)),
        }

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
            "sharded": sorted(self.sharded),
        }

    # -- persistence --------------------------------------------------------

    def save(self, path: str) -> str:
        """Write the artifact under directory ``path`` (created if
        missing): ``manifest.json`` + ``arrays.npz`` (see the module
        docstring for why device indices are not stored)."""
        if self.census is None:
            raise ValueError("GeoIndexSet.save needs at least a census")
        os.makedirs(path, exist_ok=True)
        arrays: Dict[str, np.ndarray] = {}
        for lvl in _LEVELS:
            soup = getattr(self.census, lvl)
            for f in _SOUP_FIELDS:
                arrays[f"census_{lvl}_{f}"] = np.asarray(getattr(soup, f))
        # The extent rides in the npz as float64 (exact): the quant
        # vector must see the same bounds after a reload.
        arrays["extent"] = np.asarray(self.census.extent, np.float64)
        components = ["census"]
        if self.covering is not None:
            for f in _COVER_FIELDS:
                arrays[f"covering_{f}"] = np.asarray(
                    getattr(self.covering, f))
            components.append("covering")
        manifest = {
            "format": FORMAT_NAME,
            "schema_version": SCHEMA_VERSION,
            "components": components,
            "max_level": int(self.max_level),
            "gbits": int(self.gbits),
            "max_cand": int(self.max_cand),
            "counts": {
                "states": self.census.states.n_poly,
                "counties": self.census.counties.n_poly,
                "blocks": self.census.blocks.n_poly,
                "cells": (0 if self.covering is None
                          else int(len(self.covering.lo))),
            },
            # Informational only: load() rebuilds device indices.
            "built": self.capabilities(),
            "tuning": self.tuning,
        }
        np.savez(os.path.join(path, ARRAYS_NAME), **arrays)
        with open(os.path.join(path, MANIFEST_NAME), "w") as f:
            json.dump(manifest, f, indent=2, sort_keys=True)
        return path

    @classmethod
    def load(cls, path: str, device="cuda") -> "GeoIndexSet":
        """Reload an artifact directory for ``device``; ValueError on a
        missing, foreign or newer-schema manifest.  Device indices
        rebuild lazily through ``ensure``."""
        mpath = os.path.join(path, MANIFEST_NAME)
        if not os.path.exists(mpath):
            raise ValueError(f"no {MANIFEST_NAME} under {path!r} — not a "
                             f"saved GeoIndexSet")
        with open(mpath) as f:
            manifest = json.load(f)
        if manifest.get("format") != FORMAT_NAME:
            raise ValueError(f"manifest format {manifest.get('format')!r} "
                             f"is not {FORMAT_NAME!r}")
        version = manifest.get("schema_version")
        if version not in ACCEPTED_SCHEMA_VERSIONS:
            raise ValueError(
                f"unsupported schema_version {version!r} (this build "
                f"reads versions {sorted(ACCEPTED_SCHEMA_VERSIONS)}); "
                f"re-save the artifact with a matching build")
        with np.load(os.path.join(path, ARRAYS_NAME),
                     allow_pickle=False) as z:
            arrays = {k: z[k] for k in z.files}
        extent = tuple(float(v) for v in arrays["extent"])
        soups = {lvl: PolygonSoup(**{f: arrays[f"census_{lvl}_{f}"]
                                     for f in _SOUP_FIELDS})
                 for lvl in _LEVELS}
        census = CensusMap(states=soups["states"],
                           counties=soups["counties"],
                           blocks=soups["blocks"], extent=extent)
        covering = None
        if "covering" in manifest.get("components", ()):
            val = arrays["covering_val"]
            covering = CellCovering(
                **{f: arrays[f"covering_{f}"] for f in _COVER_FIELDS},
                max_level=int(manifest["max_level"]), extent=extent,
                n_interior=int((val >= 0).sum()),
                n_boundary=int((val < 0).sum()))
        return cls(census=census, covering=covering,
                   max_level=int(manifest["max_level"]),
                   gbits=int(manifest["gbits"]),
                   max_cand=int(manifest["max_cand"]),
                   # v1 manifests predate the tuning block: empty record.
                   tuning=dict(manifest.get("tuning") or {}),
                   device=device)

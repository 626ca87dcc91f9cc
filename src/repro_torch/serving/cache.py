"""Exact hot-cell result cache for GeoServer (copy of
src/repro/serving/cache.py, on the port's own ``np_quantize_codes`` /
``np_extent_mask``; DESIGN.md §10).

Serving traffic is heavily repeated in space — the same venues, road
segments, and home cells recur across requests (the mContain deployment's
hot-spot pattern).  This cache short-circuits that traffic on the host:
points whose quantized leaf code is already known resolve to their block
id from a hash map without touching the accelerator at all.

Exactness, not heuristics: an entry is learned **only** for leaf codes
that fall inside an *interior* covering cell — a cell fully contained in
one block polygon (core/cells.py), the paper's "true hit".  Any point in
such a cell belongs to that block, so the cached answer equals what every
exact strategy computes for it (the fast path reads the same cell value;
the simple cascade PIPs its way to the same polygon).  Boundary cells and
off-extent points are never cached — they always take the correctness
fallback: the full cascade/engine on device.  The one caveat: a
capacity-overflowed engine can answer an interior point *less* exactly
than the cache (overflow keeps the bbox select); the cache stays right,
bit-identity with a degraded engine does not — size caps generously.

Keys are leaf codes from the same fp32 quantization the device applies
(``fast.np_quantize_codes``, the bit-exact host mirror of
``fast.quantize_codes``).  Off-extent points are masked with the
companion ``fast.np_extent_mask`` before lookup *and* learn:
quantization clips onto the grid border, and without the mask a far-away
point would hit a border cell's cache line (the PR 2 extent bug, serving
edition).

The LRU holds only the hot subset: at production scale the full interior
table is the 90 GiB device index — the host map is the small, traffic-
selected shadow of it, with hit/miss/insert/evict accounting for the
metrics registry.

**Thread safety** (DESIGN.md §14): one RLock serializes
``lookup``/``learn``/``snapshot``.  The compound LRU operations
(probe-then-move_to_end, insert-then-evict) are not atomic at the
OrderedDict level, so unlocked concurrent callers could over-evict past
capacity, lose inserts, or corrupt the hit/miss counters (lost
read-modify-write updates).  A *stale* entry is impossible by
construction even without the lock — an interior cell's block id never
changes — so the lock's job is purely structural integrity plus honest
accounting.  Values are immutable ints: there is no torn-read risk once
the dict itself is consistent.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict

import numpy as np

from repro_torch.core.cells import CellCovering
from repro_torch.core.fast import (np_extent_mask, np_quantize_codes,
                             quant_for_extent)

__all__ = ["CellTable", "HotCellCache", "np_extent_mask",
           "np_quantize_codes"]


@dataclasses.dataclass
class CellTable:
    """Host copies of the covering intervals — the cache's safety oracle:
    is this code in an interior cell, and of which block?"""

    lo: np.ndarray              # [n_cells] i32 sorted interval starts
    hi: np.ndarray              # [n_cells] i32 inclusive ends
    val: np.ndarray             # [n_cells] i32 (>= 0 interior block id)
    quant: np.ndarray           # [4] f32 (x0, y0, sx, sy)
    max_level: int

    @classmethod
    def from_covering(cls, cov: CellCovering) -> "CellTable":
        return cls(lo=np.asarray(cov.lo), hi=np.asarray(cov.hi),
                   val=np.asarray(cov.val),
                   quant=quant_for_extent(cov.extent, cov.max_level),
                   max_level=cov.max_level)

    def interior_value(self, codes: np.ndarray) -> np.ndarray:
        """[N] i32 — the owning block id where ``codes`` fall inside an
        interior covering cell, else -1 (boundary cell, covering gap)."""
        if len(self.lo) == 0:
            return np.full(len(codes), -1, np.int32)
        ix = np.clip(np.searchsorted(self.lo, codes, side="right") - 1,
                     0, len(self.lo) - 1)
        in_cell = (self.lo[ix] <= codes) & (codes <= self.hi[ix])
        v = self.val[ix]
        return np.where(in_cell & (v >= 0), v, -1).astype(np.int32)

class HotCellCache:
    """LRU leaf-code -> block-id map with hit/miss accounting (see module
    docstring for the exactness contract)."""

    def __init__(self, table: CellTable, capacity: int = 1 << 16):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.table = table
        self.capacity = int(capacity)
        self._map: OrderedDict[int, int] = OrderedDict()  # guarded-by: _lock
        self._lock = threading.RLock()
        self.hits = 0                  # guarded-by: _lock
        self.misses = 0                # guarded-by: _lock
        self.insertions = 0            # guarded-by: _lock
        self.evictions = 0             # guarded-by: _lock

    def __len__(self) -> int:
        with self._lock:
            return len(self._map)

    def lookup(self, codes: np.ndarray):
        """[N] codes -> (bid [N] i32 with -1 on miss, hit [N] bool).
        Deduplicates per batch: each distinct code is probed (and counted,
        and LRU-touched) once."""
        uniq, inv = np.unique(codes, return_inverse=True)
        ubid = np.full(len(uniq), -1, np.int32)
        with self._lock:
            m = self._map
            for i, code in enumerate(uniq.tolist()):
                v = m.get(code)
                if v is not None:
                    m.move_to_end(code)
                    ubid[i] = v
                    self.hits += 1
                else:
                    self.misses += 1
        bid = ubid[inv]
        return bid, bid >= 0

    def learn(self, codes: np.ndarray) -> int:
        """Insert the interior-safe subset of ``codes`` (value = the
        owning block from the covering — the exact answer by the interior
        invariant); LRU-evicts beyond capacity.  Returns insert count.
        The insert-then-evict pair runs under the cache lock, so entries
        never exceed capacity however many threads learn at once."""
        uniq = np.unique(codes)
        safe = self.table.interior_value(uniq)
        inserted = 0
        with self._lock:
            m = self._map
            for code, bid in zip(uniq.tolist(), safe.tolist()):
                if bid < 0 or code in m:
                    continue
                m[code] = bid
                inserted += 1
                if len(m) > self.capacity:
                    m.popitem(last=False)
                    self.evictions += 1
            self.insertions += inserted
        return inserted

    def snapshot(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {"entries": len(self._map), "capacity": self.capacity,
                    "hits": self.hits, "misses": self.misses,
                    "insertions": self.insertions,
                    "evictions": self.evictions,
                    "hit_rate": self.hits / total if total else 0.0}

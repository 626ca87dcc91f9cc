"""Per-block batch aggregation on top of the segment-reduce kernel (port
of src/repro/analytics/aggregate.py; DESIGN.md §16).

``BlockAggregator`` is the stateless batch layer of the analytics
subsystem: it turns assigned block ids (from any ``GeoEngine``
strategy) into per-block statistics —

  * **occupancy counts** (host ``np.bincount`` or device
    ``ops.segment_reduce``, bit-identical);
  * **crowding density** = counts / block shoelace area
    (``geometry.polygon_areas``);
  * **weighted composite indices** (HVI-style): z-score per-block
    attribute columns across blocks, then blend with caller weights;
  * a **fused assign→aggregate** path: the engine's assign and the
    aggregation prologue (invalid ids parked at ``n_blocks`` with one
    ``torch.where``) stay on the engine's device, and the reduction
    consumes that id buffer with no host round trip: on the card through
    the segment kernel (``ops.segment_counts``), for a CPU tensor through
    one ``np.bincount`` over its zero-copy ``.numpy()`` view.  Counts
    are integer accumulations, so the fused path is bit-identical to the
    unfused assign → host copy → filter → bincount path by construction;
    what fusion removes is the per-batch host work (and, on the card, the
    [N] device-to-host copy: only the [n_blocks] counts cross).

Streaming/windowed state lives in window.py; this module never holds
state between calls.  ``density`` and ``weighted_index`` stay numpy
float64.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.geometry import polygon_areas
from repro_torch.kernels import ops


def _host(x) -> np.ndarray:
    """A host numpy view of an array or tensor (copied off the card)."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


class BlockAggregator:
    """Batch per-block reductions for a fixed map of ``n_blocks`` blocks.

    Construct directly from ``n_blocks`` (+ optional [n_blocks] areas),
    or via ``from_engine`` to pick up the engine's block count, census
    geometry, device and a fused assign→aggregate path.  ``device`` is
    where array (non-tensor) inputs of ``reduce`` go: "cuda" unless the
    caller passes ``device="cpu"``; ``from_engine`` takes the engine's.
    """

    def __init__(self, n_blocks: int, areas: Optional[np.ndarray] = None,
                 *, backend: Optional[str] = None, engine=None,
                 device="cuda"):
        self.n_blocks = int(n_blocks)
        self.areas = None if areas is None \
            else np.asarray(areas, np.float64)
        if self.areas is not None and self.areas.shape != (self.n_blocks,):
            raise ValueError(f"areas {self.areas.shape} do not match "
                             f"{self.n_blocks} blocks")
        self.backend = backend
        self.engine = engine
        self.device = engine.device if engine is not None \
            else torch.device(device)

    @classmethod
    def from_engine(cls, engine, *, backend: Optional[str] = None
                    ) -> "BlockAggregator":
        block_parent, _ = engine.host_parents()
        areas = polygon_areas(engine.census.blocks) \
            if engine.census is not None else None
        return cls(len(block_parent), areas, backend=backend,
                   engine=engine)

    # -- batch reductions --------------------------------------------------

    def counts(self, bids) -> np.ndarray:
        """[n_blocks] int64 occupancy from block ids (the unfused path:
        ids brought to the host).  Ids outside [0, n_blocks) — e.g. the
        engine's -1 "not on the map" — are skipped."""
        bids = _host(bids).astype(np.int64).ravel()
        bids = bids[(bids >= 0) & (bids < self.n_blocks)]
        return np.bincount(bids, minlength=self.n_blocks)

    def reduce(self, ids, values=None) -> ops.SegmentReduce:
        """Segment reduction (count/sum/min/max) over assigned ids, on
        the ids' device (arrays go to the aggregator's device) — see
        ``ops.segment_reduce`` for the backend and bit-identity
        contract."""
        ids = torch.as_tensor(ids, device=ids.device if isinstance(
            ids, torch.Tensor) else self.device)
        if values is not None:
            values = torch.as_tensor(values, dtype=torch.float32,
                                     device=ids.device)
        return ops.segment_reduce(ids, values, n_segments=self.n_blocks,
                                  backend=self.backend)

    def fused_ids(self, points) -> torch.Tensor:
        """The fused path's first stage: engine assign + the aggregation
        prologue (invalid block ids parked at ``n_blocks``), all on the
        engine's device, so the buffer feeds ``reduce_counts`` with no
        host-side filtering.  Requires an engine (``from_engine``)."""
        if self.engine is None:
            raise ValueError("fused_ids needs an engine "
                             "(BlockAggregator.from_engine)")
        bid = self.engine.assign(points).block
        n = self.n_blocks
        return torch.where((bid < 0) | (bid >= n), n, bid)

    def reduce_counts(self, parked_ids) -> np.ndarray:
        """[n_blocks] int64 counts from a *parked* id buffer
        (``fused_ids`` output: every id in [0, n_blocks], n_blocks =
        parked/invalid).  A CUDA tensor (or an explicit kernel backend)
        goes through ``ops.segment_counts`` — the segment kernel on the
        card — and only the counts cross to the host; a CPU tensor is
        counted through its zero-copy ``.numpy()`` view — the id vector
        is never copied, masked or compacted on the host."""
        on_cuda = isinstance(parked_ids, torch.Tensor) \
            and parked_ids.device.type == "cuda"
        if on_cuda or self.backend is not None:
            out = ops.segment_counts(torch.as_tensor(parked_ids),
                                     n_segments=self.n_blocks,
                                     backend=self.backend)
            return out.cpu().numpy().astype(np.int64)
        ids = parked_ids.numpy() if isinstance(parked_ids, torch.Tensor) \
            else np.asarray(parked_ids)
        return np.bincount(ids, minlength=self.n_blocks + 1)[
            :self.n_blocks]

    def fused_counts(self, points) -> np.ndarray:
        """assign→count without bringing the id vector to the host:
        [N, 2] points -> [n_blocks] int64 counts.  Bit-identical to
        ``counts(engine.assign(points).block)`` — integer accumulation is
        order-free."""
        return self.reduce_counts(self.fused_ids(points))

    # -- derived statistics ------------------------------------------------

    def density(self, counts) -> np.ndarray:
        """[n_blocks] float64 crowding density = counts / block area
        (zero-area blocks report 0).  Requires areas (``from_engine``
        with a census, or explicit ``areas=``)."""
        if self.areas is None:
            raise ValueError("density needs block areas")
        counts = _host(counts).astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.where(self.areas > 0, counts / self.areas, 0.0)

    def weighted_index(self, columns, weights) -> np.ndarray:
        """HVI-style composite: z-score each [n_blocks] column across
        blocks (constant columns z-score to 0), blend with ``weights``
        [n_cols].  float64 throughout; returns [n_blocks]."""
        cols = np.asarray(columns, np.float64)
        if cols.ndim == 1:
            cols = cols[:, None]
        w = np.asarray(weights, np.float64).ravel()
        if cols.shape[0] != self.n_blocks or w.shape != (cols.shape[1],):
            raise ValueError(f"columns {cols.shape} / weights {w.shape} "
                             f"do not match {self.n_blocks} blocks")
        mean = cols.mean(axis=0)
        std = cols.std(axis=0)
        std = np.where(std > 0, std, 1.0)
        return ((cols - mean) / std) @ w

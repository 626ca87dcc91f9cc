"""Shared resolution core (port of src/repro/core/resolve.py; DESIGN.md §3).

    candidate filter -> fixed-capacity compaction -> crossing-number PIP
    against <= K candidate polygons -> fallback policy -> overflow-counted
    stats.

``resolve_candidates`` implements that pattern once.  Two PIP schedules
give identical assignments (the first matching candidate in slot order):

  * sequential — K kernel calls over the whole compacted buffer;
  * two_phase  — slot 0 for the whole buffer, then one batched call over
    the remaining K-1 candidates of the compacted slot-0 misses.

Candidate PIP has two data paths with identical results: the gathered
path (``edges_table[pid]`` into an [R, E, 4] buffer, then
``ops.pip_gathered``) and, when ``edge_pool=`` is given, the candidate
path (``ops.pip_candidates`` reads each candidate's blocks straight out
of the blocked-CSR pool).

Counters are 0-d tensors on the points' device; nothing here reads one
back to the host.

Under a capturing profiler the primitive is the ``geo.resolve`` span,
split into ``geo.resolve.compact`` (compaction of the needing rows),
``.candidates`` (their candidate ids), ``.pip`` (the PIP schedule with
its gathers and kernels) and ``.scatter`` (fallback, write-back,
counters).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Union

import torch

from repro_torch.core.compact import (capacity_for, compact_indices,
                                      scatter_filled)
from repro_torch.kernels import ops
from repro_torch.obs.profile import span

# Candidate table for N points: a precomputed [N, K] id tensor, or a
# callable (idx [R], sub_pts [R, 2]) -> [R, K] evaluated after
# compaction, on the much smaller buffer.
CandidateFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
Candidates = Union[torch.Tensor, CandidateFn]


@dataclasses.dataclass
class ResolveStats:
    """Per-resolve accounting (0-d i32/i64 tensors).

    n_need:      points that required candidate resolution.
    n_pip:       candidate PIP tests actually issued.
    overflow:    points dropped by the fixed-capacity compaction.
    phase2_miss: two-phase only — slot-0 misses that got no phase-2 slot
                 and fell straight to the fallback policy.
    """

    n_need: Any
    n_pip: Any
    overflow: Any
    phase2_miss: Any

    def as_dict(self) -> dict:
        return {"n_need": self.n_need, "n_pip": self.n_pip,
                "overflow": self.overflow, "phase2_miss": self.phase2_miss}

    def merge(self, other: "ResolveStats") -> "ResolveStats":
        """Counter-wise sum — aggregates resolves across micro-batches."""
        return ResolveStats(
            n_need=self.n_need + other.n_need,
            n_pip=self.n_pip + other.n_pip,
            overflow=self.overflow + other.overflow,
            phase2_miss=self.phase2_miss + other.phase2_miss)


@dataclasses.dataclass
class GeoStats:
    """Unified cross-strategy stats (0-d tensors unless noted).

    n_need:   points that needed candidate resolution (boundary-cell hits
              for the cell index).
    n_pip:    candidate PIP tests issued (0 for fast-approx).
    overflow: points whose resolution a fixed-capacity compaction dropped.
    extra:    the strategy's native breakdown (``n_boundary``,
              ``phase2_miss``, ``bbox_skips`` for the one-pass cascade).
    """

    n_need: Any
    n_pip: Any
    overflow: Any
    extra: Any = dataclasses.field(default_factory=dict)

    def merge(self, other: "GeoStats") -> "GeoStats":
        """Counter-wise sum across micro-batches (serving aggregation).

        ``extra`` is summed leaf by leaf over the nested dicts, so both
        stats must come from the same strategy + config (identical extra
        structure) — the serving layer keeps one running GeoStats per
        engine.  Non-mutating; the sums stay on the counters' device.
        """
        return GeoStats(n_need=self.n_need + other.n_need,
                        n_pip=self.n_pip + other.n_pip,
                        overflow=self.overflow + other.overflow,
                        extra=_add_nested(self.extra, other.extra))

    def as_dict(self) -> dict:
        """Flat JSON-ready counters (python ints)."""
        d = {"n_need": int(self.n_need), "n_pip": int(self.n_pip),
             "overflow": int(self.overflow),
             "phase2_miss": _sum_nested(self.extra, "phase2_miss")}
        if isinstance(self.extra, dict):
            d["n_boundary"] = int(self.extra.get("n_boundary", self.n_need))
            if "n_dropped" in self.extra:
                d["n_dropped"] = int(self.extra["n_dropped"])
        else:
            d["n_boundary"] = d["n_need"]
        return d


def _add_nested(a, b):
    """Leaf-wise sum of two nested dicts of the same structure."""
    if isinstance(a, dict):
        if set(a) != set(b):
            raise ValueError(f"cannot merge stats with keys {sorted(a)} "
                             f"and {sorted(b)}")
        return {k: _add_nested(a[k], b[k]) for k in a}
    return a + b


def _sum_nested(tree, key: str) -> int:
    """Sum every scalar leaf named ``key`` anywhere in a nested dict."""
    total = 0
    if isinstance(tree, dict):
        for k, v in tree.items():
            if isinstance(v, dict):
                total += _sum_nested(v, key)
            elif k == key:
                total += int(v)
    return total


@dataclasses.dataclass
class AssignResult:
    """(state, county, block) ids plus GeoStats; iterable for tuple-style
    unpacking."""

    state: Any
    county: Any
    block: Any
    stats: Any

    def __iter__(self):
        return iter((self.state, self.county, self.block, self.stats))


def onepass_stats(flags: torch.Tensor, nrest: torch.Tensor,
                  nskip: torch.Tensor) -> dict:
    """Stats of the one-pass cascade, reproducing ``_pip_two_phase``'s
    accounting from the kernel's per-point outputs: every boundary point
    pays its slot-0 test, and each slot-0 miss also counts its valid
    slot-1..K-1 candidates.  overflow / phase2_miss are structurally 0
    (no compaction buffer); bbox_skips rides in the extra dict only."""
    boundary = (flags & 1) == 1
    slot0_hit = (flags & 2) == 2
    n_boundary = boundary.sum()
    n_pip = n_boundary + torch.where(boundary & ~slot0_hit, nrest, 0).sum()
    zero = torch.zeros((), dtype=torch.int32, device=flags.device)
    return {"n_boundary": n_boundary, "n_pip": n_pip,
            "overflow": zero, "phase2_miss": zero,
            "bbox_skips": torch.where(boundary, nskip, 0).sum()}


def first_k_candidates(mask: torch.Tensor, k: int) -> torch.Tensor:
    """Slots of the first min(k, C) set bits per row of a [R, C] mask
    (else -1); k is clamped so narrow candidate tables (tiny maps) work.

    Set bits score ``C - slot`` (unique, > 0), unset bits 0, so the top
    scores are the earliest set slots in order; ``topk``'s order among
    tied zeros does not matter, since every zero maps to -1."""
    c = mask.shape[1]
    iota = torch.arange(c, dtype=torch.int32, device=mask.device)[None, :]
    score = torch.where(mask != 0, c - iota, 0)     # larger = earlier slot
    vals, _ = torch.topk(score, min(k, c), dim=1, sorted=True)
    return torch.where(vals > 0, c - vals, -1)      # [R, k] slot indices


def _pip_ids(points, pid, edges_table, edge_pool, backend):
    """Inside mask of each point vs its own candidate id (pid < 0 = never
    inside).  Candidate path when an edge pool is given, gathered path
    otherwise.

    The candidate path runs in candidate-id-sorted order, so rows that
    read the same pool blocks sit next to each other.  The permutation is
    local: rows are inverse-permuted before returning, and each row's
    count depends only on its own (point, id), so callers see results
    bit-identical to the unsorted order.
    """
    if edge_pool is not None:
        _, order = torch.sort(torch.where(pid >= 0, pid, 2**31 - 1),
                              stable=True)
        inside = ops.pip_candidates(points[order], pid[order], edge_pool,
                                    backend=backend)
        out = torch.empty_like(inside)
        out[order] = inside
        return out
    edges = edges_table[pid.clamp(0, edges_table.shape[0] - 1)]
    return ops.pip_gathered(points, edges, backend=backend) & (pid >= 0)


def _pip_sequential(points, cand_ids, edges_table, need, backend,
                    edge_pool=None):
    """First matching candidate in slot order, K sequential kernel calls.

    Returns (assign [R] i32 with -1 = no match, n_pip, phase2_miss == 0).
    """
    dev = points.device
    assign = torch.full((points.shape[0],), -1, dtype=torch.int32,
                        device=dev)
    n_pip = torch.zeros((), dtype=torch.int64, device=dev)
    for kk in range(cand_ids.shape[1]):
        pid = cand_ids[:, kk]
        active = need & (pid >= 0) & (assign < 0)
        inside = _pip_ids(points, pid, edges_table, edge_pool, backend)
        assign = torch.where(active & inside, pid, assign)
        n_pip = n_pip + active.sum()
    return assign, n_pip, torch.zeros((), dtype=torch.int32, device=dev)


def _pip_two_phase(points, cand_ids, edges_table, need, backend, cap2,
                   edge_pool=None):
    """Same assignment as ``_pip_sequential`` in two batched phases: slot
    0 for everyone, then slots 1..K-1 for the ``cap2`` compacted slot-0
    misses.  Misses beyond cap2 degrade to the caller's fallback and are
    counted in phase2_miss."""
    dev = points.device
    kk = cand_ids.shape[1]
    pid0 = cand_ids[:, 0]
    in0 = _pip_ids(points, pid0, edges_table, edge_pool, backend)
    in0 = in0 & (pid0 >= 0) & need
    n_pip = need.sum()
    assign = torch.where(in0, pid0, -1)
    if kk == 1:
        return assign, n_pip, torch.zeros((), dtype=torch.int32, device=dev)

    miss = need & ~in0
    n_miss = miss.sum()
    idx2, ok2 = compact_indices(miss, cap2)
    # Unfilled phase-2 slots alias row 0; ok2 guards the counter so a
    # row-0 miss does not phantom-count PIP tests for them.
    real2 = miss[idx2] & ok2
    phase2_miss = n_miss - real2.sum()
    rest = cand_ids[idx2, 1:]                        # [R2, K-1]
    flat_pid = rest.reshape(-1)
    pts_rep = torch.repeat_interleave(points[idx2], kk - 1, dim=0)
    in_r = _pip_ids(pts_rep, flat_pid, edges_table, edge_pool, backend)
    in_r = (in_r & (flat_pid >= 0)).reshape(-1, kk - 1)
    n_pip = n_pip + (real2[:, None] & (rest >= 0)).sum()
    score = torch.where(
        in_r, kk - torch.arange(1, kk, device=dev)[None, :], 0)
    best = torch.argmax(score, dim=1)
    hit2 = in_r.any(dim=1) & miss[idx2] & ok2
    val2 = torch.gather(rest, 1, best[:, None])[:, 0]
    assign = scatter_filled(assign, idx2, ok2,
                            torch.where(hit2, val2, assign[idx2]))
    return assign, n_pip, phase2_miss


def resolve_candidates(points: torch.Tensor, cand_ids: Candidates,
                       edges_table: torch.Tensor, need: torch.Tensor, *,
                       cap: int, k: int | None = None,
                       backend: str | None = None,
                       prior: torch.Tensor | None = None,
                       fallback: str = "prior",
                       two_phase: bool = False,
                       cap2: int | None = None,
                       edge_pool=None):
    """THE compaction + candidate-PIP + fallback primitive.

    Args:
      points:      [N, 2] query points (full batch).
      cand_ids:    [N, K] candidate polygon ids (-1 = empty slot), or a
                   callable gathering them post-compaction.
      edges_table: [P, E, 4] edge table the candidate ids index into.
      need:        [N] bool — points requiring resolution.
      cap:         static compaction capacity (compact.capacity_for).
      k:           optional truncation of the candidate list to its first
                   k slots (after the compaction).
      backend:     kernel backend override (resolved once, here).
      prior:       [N] i32 assignment so far (default all -1).
      fallback:    "prior" or "first" (slot-0 candidate) for a needed
                   but unmatched point.
      two_phase:   PIP schedule (see module docstring).
      cap2:        two-phase phase-2 capacity (default cap / 4).
      edge_pool:   optional ``ops.EdgePool`` over the same polygons; when
                   given, candidate PIP reads the pool directly.

    Returns:
      (assign [N] i32, ResolveStats).
    """
    n = points.shape[0]
    backend = ops.resolve_backend(backend, points.device)
    with span("geo.resolve"):
        with span("geo.resolve.compact"):
            if prior is None:
                prior = torch.full((n,), -1, dtype=torch.int32,
                                   device=points.device)
            idx, slot_ok = compact_indices(need, cap)
            sub_pts = points[idx]
            sub_need = need[idx] & slot_ok
        with span("geo.resolve.candidates"):
            sub_cand = cand_ids(idx, sub_pts) if callable(cand_ids) \
                else cand_ids[idx]
            if k is not None:
                sub_cand = sub_cand[:, :k]
        with span("geo.resolve.pip"):
            if two_phase:
                if cap2 is None:
                    cap2 = capacity_for(cap, 0.25, ceiling=cap)
                resolved, n_pip, p2_miss = _pip_two_phase(
                    sub_pts, sub_cand, edges_table, sub_need, backend, cap2,
                    edge_pool=edge_pool)
            else:
                resolved, n_pip, p2_miss = _pip_sequential(
                    sub_pts, sub_cand, edges_table, sub_need, backend,
                    edge_pool=edge_pool)
        with span("geo.resolve.scatter"):
            if fallback == "first":
                fb = torch.where(sub_cand[:, 0] >= 0, sub_cand[:, 0], -1)
            elif fallback == "prior":
                fb = prior[idx]
            else:
                raise ValueError(f"unknown fallback policy: {fallback!r}")
            new_val = torch.where(sub_need,
                                  torch.where(resolved >= 0, resolved, fb),
                                  prior[idx])
            assign = scatter_filled(prior, idx, slot_ok, new_val)
            n_need = need.sum()
            overflow = n_need - sub_need.sum()
    return assign, ResolveStats(n_need=n_need, n_pip=n_pip,
                                overflow=overflow, phase2_miss=p2_miss)

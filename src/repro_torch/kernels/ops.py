"""Public kernel API: natural layouts, empty-table normalization, backend
dispatch (port of src/repro/kernels/ops.py).

Backend selection (``REPRO_TORCH_KERNELS`` env var or explicit
``backend=``):
  * ``cuda`` — the hand-written CUDA kernels (``csrc/``);
  * ``ref``  — the plain PyTorch twins in ref.py;
  * ``auto`` — ``cuda`` for tensors on a CUDA device, ``ref`` for CPU
               tensors (default).
Asking for ``cuda`` with CPU tensors raises, and so does asking for
``ref`` with CUDA tensors: no tensor on the card ever reaches a twin.

The kernels load points as float2 and edges / boxes as float4, so every
tensor ``ops`` hands a kernel wrapper goes through ``aligned`` first: a
contiguous view that starts mid-vector (``flat[1:].view(-1, 2)``) is
copied, as ``repro`` maps any array.
"""
from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.kernels import bbox as bbox_kernels
from repro_torch.kernels import cascade as cascade_kernels
from repro_torch.kernels import flash_attn as flash_kernels
from repro_torch.kernels import gather_pip as gather_pip_kernels
from repro_torch.kernels import pip as pip_kernels
from repro_torch.kernels import ref
from repro_torch.kernels import segment as segment_kernels
# re-export: ops is the one import surface strategy code uses.
# geolint: ignore[unused-import] -- re-export through ops.*
from repro_torch.kernels.gather_pip import (DEF_BE, EdgePool,  # noqa: F401
                                            build_edge_pool)

# A padding point guaranteed outside every bbox / polygon we generate.
FAR = 1.0e30

BACKENDS = ("cuda", "ref")


def resolve_backend(backend: str | None, device) -> str:
    """The backend that runs tensors on ``device`` (see module doc)."""
    b = backend or os.environ.get("REPRO_TORCH_KERNELS", "auto")
    on_cuda = torch.device(device).type == "cuda"
    if b == "auto":
        b = "cuda" if on_cuda else "ref"
    if b not in BACKENDS:
        raise ValueError(f"unknown kernel backend {b!r}; expected one of "
                         f"{BACKENDS} or 'auto'")
    if (b == "cuda") != on_cuda:
        raise ValueError(f"kernel backend {b!r} cannot run tensors on "
                         f"{device}")
    return b


def aligned(t: torch.Tensor, nbytes: int) -> torch.Tensor:
    """``t`` made contiguous, as it is if its data starts on an
    ``nbytes`` boundary, else a contiguous copy (a new allocation, which
    both allocators align far past 16 bytes)."""
    t = t.contiguous()
    return t if t.data_ptr() % nbytes == 0 else t.clone()


def pip_one(points: torch.Tensor, edges: torch.Tensor,
            backend: str | None = None) -> torch.Tensor:
    """Inside mask of [N, 2] points vs one polygon's [E, 4] edge table."""
    b = resolve_backend(backend, points.device)
    if b == "ref":
        return ref.pip_one(points, edges)
    cross = pip_kernels.crossings_one(aligned(points.float(), 8),
                                      aligned(edges.float(), 16))
    return (cross & 1).bool()


def pip_gathered(points: torch.Tensor, edges: torch.Tensor,
                 backend: str | None = None) -> torch.Tensor:
    """Inside mask where each point brings its own [E, 4] edges: [N, E, 4]."""
    b = resolve_backend(backend, points.device)
    if b == "ref":
        return ref.pip_gathered(points, edges)
    cross = pip_kernels.crossings_gathered(aligned(points.float(), 8),
                                           aligned(edges.float(), 16))
    return (cross & 1).bool()


def pip_candidates(points: torch.Tensor, pids: torch.Tensor, pool: EdgePool,
                   backend: str | None = None) -> torch.Tensor:
    """Inside mask of [N, 2] points vs their own candidate polygon ids [N]
    (id < 0 = no candidate, never inside), read straight out of the
    blocked-CSR ``pool`` — no gathered [N, E, 4] edge table.  Both
    backends resolve each id's block range and live-edge count from the
    pool themselves (ids past the table clamp to its last polygon), so
    a row's count is 0 without a candidate."""
    b = resolve_backend(backend, points.device)
    if pool.n_poly == 0:               # empty polygon table: nothing matches
        return torch.zeros(points.shape[0], dtype=torch.bool,
                           device=points.device)
    args = (pids.int().contiguous(), aligned(points.float(), 8), pool.first,
            pool.count, pool.live, pool.blocks)
    if b == "ref":
        cross = ref.crossings_candidates(*args, pool.max_blocks)
    else:
        cross = gather_pip_kernels.crossings_candidates(
            *args, max_blocks=pool.max_blocks)
    return (cross & 1).bool()


def assign_cascade(points: torch.Tensor, quant: torch.Tensor,
                   cell_lo: torch.Tensor, cell_hi: torch.Tensor,
                   cell_val: torch.Tensor, top_start: torch.Tensor,
                   cand: torch.Tensor, bbox: torch.Tensor, pool: EdgePool,
                   *, max_level: int, gbits: int, search_iters: int,
                   backend: str | None = None):
    """One-pass fused cascade: [N, 2] points -> (bid, flags, nrest,
    nskip), each [N] i32 (kernels/cascade.py has the encoding).

    ``bbox`` is the [P, 4] (xmin, xmax, ymin, ymax) table aligned with
    the pool's polygon ids.  Empty cell / candidate / polygon tables are
    normalized here so both backends see the same never-matching
    sentinels.
    """
    dev = points.device
    b = resolve_backend(backend, dev)
    i32 = torch.int32
    if cand.shape[0] == 0 or cand.shape[1] == 0:
        cand = torch.full((1, max(cand.shape[1], 1)), -1, dtype=i32,
                          device=dev)
    if cell_lo.shape[0] == 0:
        # One unreachable row (lo > hi never brackets a code).
        cell_lo = torch.ones(1, dtype=i32, device=dev)
        cell_hi = torch.zeros(1, dtype=i32, device=dev)
        cell_val = torch.zeros(1, dtype=i32, device=dev)
    first, count, blocks = pool.first, pool.count, pool.blocks
    if pool.n_poly == 0:
        first = torch.zeros(1, dtype=i32, device=dev)
        count = torch.zeros(1, dtype=i32, device=dev)
        bbox = torch.tensor([[1.0, 0.0, 1.0, 0.0]], device=dev)  # empty box
    elif bbox.shape[0] != pool.n_poly:
        raise ValueError(f"bbox rows {bbox.shape[0]} != pool polygons "
                         f"{pool.n_poly}")
    iters = cascade_kernels.effective_iters(cell_lo.shape[0], gbits,
                                            search_iters)
    if b == "ref":
        return ref.assign_cascade(
            points, quant, cell_lo, cell_hi, cell_val, top_start, cand,
            bbox, first, count, blocks, max_level=max_level, gbits=gbits,
            search_iters=iters, max_blocks=pool.max_blocks)
    return cascade_kernels.assign_cascade(
        aligned(points.float(), 8), quant, cell_lo, cell_hi, cell_val,
        top_start, cand, bbox, first, count, blocks, max_level=max_level,
        gbits=gbits, search_iters=iters)


def bbox_mask(points: torch.Tensor, boxes: torch.Tensor,
              backend: str | None = None) -> torch.Tensor:
    """[N, M] int8 membership of points in a shared [M, 4] box table."""
    b = resolve_backend(backend, points.device)
    if b == "ref":
        return ref.bbox_mask(points, boxes)
    return bbox_kernels.bbox_mask(aligned(points.float(), 8),
                                  aligned(boxes.float(), 16))


def bbox_mask_gathered(points: torch.Tensor, boxes: torch.Tensor,
                       backend: str | None = None) -> torch.Tensor:
    """[N, C] int8 membership in per-point gathered boxes [N, C, 4].

    A torch op on every backend, as in the reference: the comparisons
    over the gathered boxes are bound by reading them.  ``backend`` is
    still validated, so callers route every geometry op through here
    uniformly.
    """
    resolve_backend(backend, points.device)
    return ref.bbox_mask_gathered(points, boxes)


def bbox_count_select(points: torch.Tensor, boxes: torch.Tensor,
                      backend: str | None = None):
    """Membership count + largest containing slot over per-point gathered
    boxes [N, C, 4] (padded slots already empty).  Returns (count [N]
    i32, sel [N] i32)."""
    b = resolve_backend(backend, points.device)
    if b == "ref":
        return ref.bbox_count_select(points, boxes)
    return bbox_kernels.bbox_count_select(aligned(points.float(), 8),
                                          aligned(boxes.float(), 16))


def bbox_select_children(points: torch.Tensor, parent: torch.Tensor,
                         children_table: torch.Tensor,
                         bbox_table: torch.Tensor, k: int,
                         backend: str | None = None):
    """The cascade's bbox step below the state level: each point against
    the boxes of its parent's children, read by id from the level's
    tables (children [P+1, C] i32 and boxes [M+1, 4] f32, each with its
    sentinel row).  Returns (count [N] i32, pick [N] i32 — the child of
    the largest containing slot, -1 if none; first [N, min(k, C)] i32 —
    the first containing children in slot order, -1 after them)."""
    b = resolve_backend(backend, points.device)
    if b == "ref":
        return ref.bbox_select_children(points, parent, children_table,
                                        bbox_table, k)
    return bbox_kernels.bbox_select_children(
        aligned(points.float(), 8), parent.int().contiguous(),
        children_table.int().contiguous(), aligned(bbox_table.float(), 16),
        k)


class SegmentReduce(NamedTuple):
    """Per-segment aggregates of ``segment_reduce`` (all [S]-shaped
    tensors).  ``min``/``max`` are only meaningful where ``count > 0``
    (empty segments carry the +inf/-inf reduction identities)."""

    count: torch.Tensor                # i32
    sum: torch.Tensor                  # f32
    min: torch.Tensor                  # f32
    max: torch.Tensor                  # f32


def segment_reduce(ids: torch.Tensor, values: Optional[torch.Tensor] = None,
                   *, n_segments: int,
                   backend: str | None = None) -> SegmentReduce:
    """Per-block aggregation of assigned ids (DESIGN.md §16): count /
    sum / min / max of ``values`` grouped by ``ids`` over ``n_segments``
    blocks.  Rows with ids outside [0, n_segments) — the engine's -1
    "off map" answer included — are ignored on every backend.

    ``values=None`` aggregates a zero column (callers wanting only
    occupancy counts).  The kernel path stable-sorts rows by id on the
    device first (glue, as ``jnp.argsort`` is in the reference); the ref
    path is the plain twin.  Semantic ground truth is
    ``ref.np_segment_reduce`` (numpy bincount, f64 accumulate).
    """
    b = resolve_backend(backend, ids.device)
    ids = ids.reshape(-1).to(torch.int32)
    if values is not None:
        values = values.reshape(-1).to(torch.float32)
        if values.shape != ids.shape:
            raise ValueError(f"values {tuple(values.shape)} do not match "
                             f"ids {tuple(ids.shape)}")
    # Park every invalid row at the scratch segment so all backends see
    # one normalized id range [0, n_segments].
    invalid = (ids < 0) | (ids >= n_segments)
    ids = torch.where(invalid, n_segments, ids)
    if b == "ref":
        out = ref.segment_reduce(ids, values, n_segments)
    else:
        ids_s, order = torch.sort(ids, stable=True)
        # A zero column (None) is neither gathered nor read: the kernel
        # takes the counts from the segment bounds alone.
        out = segment_kernels.segment_reduce_sorted(
            ids_s, None if values is None else values[order], n_segments)
    count, total, vmin, vmax = out
    # Normalize empty-segment sentinels once, after any backend, so the
    # backends are identical by construction even if a reduction
    # identity differs in sign-of-zero or NaN handling.
    empty = count == 0
    return SegmentReduce(
        count.to(torch.int32),
        torch.where(empty, 0.0, total),
        torch.where(empty, float("inf"), vmin),
        torch.where(empty, float("-inf"), vmax))


def segment_counts(ids: torch.Tensor, *, n_segments: int,
                   backend: str | None = None) -> torch.Tensor:
    """[S] i32 occupancy counts of assigned ids (invalid ids ignored)."""
    return segment_reduce(ids, None, n_segments=n_segments,
                          backend=backend).count


def assign_aggregate(points: torch.Tensor, quant: torch.Tensor,
                     cell_lo: torch.Tensor, cell_hi: torch.Tensor,
                     cell_val: torch.Tensor, top_start: torch.Tensor,
                     cand: torch.Tensor, bbox: torch.Tensor, pool: EdgePool,
                     *, n_segments: int, max_level: int, gbits: int,
                     search_iters: int,
                     values: Optional[torch.Tensor] = None,
                     backend: str | None = None):
    """Fused assign→aggregate: the one-pass cascade immediately followed
    by the segment reduction, both on the points' device, so the [N] id
    vector never crosses to the host — only the [S] per-block
    aggregates do, when the caller reads them.

    Returns ``(SegmentReduce, (bid, flags, nrest, nskip))`` — the raw
    cascade outputs ride along for ``onepass_stats`` accounting.
    """
    bid, flags, nrest, nskip = assign_cascade(
        points, quant, cell_lo, cell_hi, cell_val, top_start, cand, bbox,
        pool, max_level=max_level, gbits=gbits, search_iters=search_iters,
        backend=backend)
    red = segment_reduce(bid, values, n_segments=n_segments,
                         backend=backend)
    return red, (bid, flags, nrest, nskip)


def flash_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               causal: bool = True, backend: str | None = None):
    """Causal or full self-attention of q [B, S, H, D] over k, v
    [B, S, KH, D] (KV heads repeated to H) -> [B, S, H, D] in q's dtype,
    any S: the flash kernel on ``cuda``, its plain twin on ``ref`` (the
    wrapper picks by the tensors' device, which ``resolve_backend`` has
    matched to the backend)."""
    resolve_backend(backend, q.device)
    return flash_kernels.flash_attn(q, k, v, causal=causal)


def edges_from_soup_np(verts: np.ndarray) -> np.ndarray:
    """[P, max_v+1, 2] padded rings -> [P, max_v, 4] edge tables (host)."""
    a = verts[:, :-1, :]
    c = verts[:, 1:, :]
    return np.concatenate([a, c], axis=-1)

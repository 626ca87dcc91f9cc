"""Bounding-box filter of the simple cascade (port of
src/repro/kernels/bbox.py; paper §III).

Kernels: ``csrc/bbox.cu``.

  * ``bbox_mask`` replaces the Pallas ``bbox_mask``
    (src/repro/kernels/bbox.py:57): the [N, M] int8 membership of N
    points in one shared [M, 4] box table — the cascade's state level.
    What bounds it on the card: bytes, 8 per point in and M out, against
    4 comparisons per (point, box).  The first design (one thread per
    output byte, each with a 64-bit division) was bound by instruction
    issue instead, at ~7x its bound.  Design: the mask is cut into
    aligned 16-byte chunks, each written by one 16-byte store from one
    thread that keeps the chunk's 16 boxes in registers, so a byte costs
    4 compares and its packing, with no division and no shared-memory
    load.  Where C = M / gcd(M, 16) <= 256, 16 / gcd(M, 16) rows make
    a super-row of C chunks whose chunk c always
    holds the same boxes; thread t of a persistent block takes chunk
    t mod C of a run of super-rows, so a warp stores 512 contiguous bytes
    and the next pass's points load while this one's are tested.  The
    rest (odd M above 256) hold 512 boxes a warp and write each point's
    run of a tile.  One launch either way.
  * ``bbox_count_select`` replaces the Pallas ``bbox_count_select``
    (src/repro/kernels/bbox.py:80): per point, over its own gathered
    [C, 4] boxes, the count of containing boxes and the largest
    containing slot (-1 if none) — the county and block levels.  What
    bounds it: reading the gathered [N, C, 4] f32 boxes, 16 bytes per box
    for 4 comparisons.  Design: the natural [N, C, 4] layout (no
    transpose to the TPU's [N, 4, C] lanes, no padding of C to 128); one
    warp per point, lane j loads box j as one float4 and
    ``__ballot_sync`` gives the containing set, 32 slots per step
    (``__popc`` the count, ``31 - __clz`` the largest slot).  At C = 8
    (counties) 24 of the 32 lanes idle.  Not on the cascade's path:
    ``bbox_select_children`` reads the boxes by id instead.
  * ``bbox_select_children`` replaces no Pallas kernel: it is the
    cascade's county and block bbox step in one launch (paper §III: a
    point is tested against the children of its parent).  Per point it
    reads the parent's row of the children table and each child's box by
    id, and gives the count of containing children, the pick (the child
    of the largest containing slot) and the first k containing children
    in slot order — what the glue around ``bbox_count_select`` computed
    from an [N, C] id gather, an [N, C, 4] box gather and a ``topk``.
    What bounds it: the tables stay in L2 (3.5 MB of boxes at the paper's
    220,864 blocks), so HBM sees the points, parents and outputs (36
    bytes a point at k = 4) and each table once, and the L2 (4 + 16) C
    bytes a point.  Design: one warp per point, lane j reads slot j's id
    and box (a parent's children have consecutive ids, so the box loads
    are contiguous), and a ballot over 32 slots a step gives the count,
    the pick and each containing slot's place among the first k.  On an
    H100 (700 W) both levels of a 2^22-point paper batch (C 58 and 68)
    take 2.03 ms: 10.6 GB of L2 reads at 5.2 TB/s.

All take open intervals on f32 with no arithmetic, so they are exact:
NaN points and empty boxes (xmin > xmax) never match.  ``ops.bbox_mask``
/ ``ops.bbox_count_select`` / ``ops.bbox_select_children`` are the
public API (backend dispatch).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

def bbox_mask(points: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """[N, M] int8 membership of [N, 2] f32 points in a shared [M, 4] f32
    box table.  CPU and meta tensors go to the plain twin; CUDA tensors
    launch the kernel on the current stream, without synchronizing."""
    if points.device.type != "cuda":
        return ref.bbox_mask(points, boxes)
    dev = points.device
    n = points.shape[0]
    _build.require(points, "points", torch.float32, (n, 2), dev)
    _build.require(boxes, "boxes", torch.float32, (None, 4), dev)
    _build.require_aligned(points, "points", 8)
    _build.require_aligned(boxes, "boxes", 16)
    m = boxes.shape[0]
    if m >= 2**31:
        raise ValueError(f"bbox_mask: {m} boxes out of range")
    out = torch.empty((n, m), dtype=torch.int8, device=dev)
    if n == 0 or m == 0:
        return out
    _build.require_aligned(out, "out", 16)
    lib = _build.load()
    with torch.cuda.device(dev):
        status = lib.repro_bbox_mask(
            _build.ptr(points), _build.ptr(boxes), _build.ptr(out), n, m,
            _build.stream_of(points))
    _build.check(status, "bbox_mask")
    return out


def bbox_count_select(points: torch.Tensor, boxes: torch.Tensor):
    """(count [N] i32, sel [N] i32) of [N, 2] f32 points over their own
    [N, C, 4] f32 boxes (padded slots empty).  CPU and meta tensors go to the
    plain twin; CUDA tensors launch the kernel on the current stream,
    without synchronizing."""
    if points.device.type != "cuda":
        return ref.bbox_count_select(points, boxes)
    dev = points.device
    n = points.shape[0]
    _build.require(points, "points", torch.float32, (n, 2), dev)
    _build.require(boxes, "boxes", torch.float32, (n, None, 4), dev)
    _build.require_aligned(points, "points", 8)
    _build.require_aligned(boxes, "boxes", 16)
    count = torch.empty(n, dtype=torch.int32, device=dev)
    sel = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return count, sel
    lib = _build.load()
    with torch.cuda.device(dev):
        status = lib.repro_bbox_count_select(
            _build.ptr(points), _build.ptr(boxes), _build.ptr(count),
            _build.ptr(sel), n, boxes.shape[1], _build.stream_of(points))
    _build.check(status, "bbox_count_select")
    return count, sel


def bbox_select_children(points: torch.Tensor, parent: torch.Tensor,
                         children_table: torch.Tensor,
                         bbox_table: torch.Tensor, k: int):
    """(count [N] i32, pick [N] i32, first [N, min(k, C)] i32) of [N, 2]
    f32 points over the children of their [N] i32 parents: the children
    table [P+1, C] i32 (-1 padded, sentinel row last) and the box table
    [M+1, 4] f32 (empty sentinel box last); ``ref.bbox_select_children``
    has the semantics.  CPU and meta tensors go to the plain twin; CUDA
    tensors launch the kernel on the current stream, without
    synchronizing."""
    if points.device.type != "cuda":
        return ref.bbox_select_children(points, parent, children_table,
                                        bbox_table, k)
    dev = points.device
    n = points.shape[0]
    _build.require(points, "points", torch.float32, (n, 2), dev)
    _build.require(parent, "parent", torch.int32, (n,), dev)
    _build.require(children_table, "children_table", torch.int32,
                   (None, None), dev)
    _build.require(bbox_table, "bbox_table", torch.float32, (None, 4), dev)
    _build.require_aligned(points, "points", 8)
    _build.require_aligned(bbox_table, "bbox_table", 16)
    rows, c = children_table.shape
    m = bbox_table.shape[0]
    if rows < 1 or m < 1 or k < 1:
        raise ValueError(f"bbox_select_children: {rows} children rows, {m} "
                         f"boxes, k {k} (the tables need their sentinel "
                         f"rows, k at least 1)")
    if rows >= 2**31 or m >= 2**31:
        raise ValueError(f"bbox_select_children: {rows} children rows or "
                         f"{m} boxes out of range")
    kk = min(k, c)
    count = torch.empty(n, dtype=torch.int32, device=dev)
    pick = torch.empty(n, dtype=torch.int32, device=dev)
    first = torch.empty((n, kk), dtype=torch.int32, device=dev)
    if n == 0:
        return count, pick, first
    lib = _build.load()
    with torch.cuda.device(dev):
        status = lib.repro_bbox_select_children(
            _build.ptr(points), _build.ptr(parent),
            _build.ptr(children_table), _build.ptr(bbox_table),
            _build.ptr(count), _build.ptr(pick), _build.ptr(first), n,
            rows - 1, c, m, kk, _build.stream_of(points))
    _build.check(status, "bbox_select_children")
    return count, pick, first

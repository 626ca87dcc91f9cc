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
    (counties) 24 of the 32 lanes idle; a sub-warp layout, and gathering
    the boxes inside the kernel instead of reading the caller's [N, C, 4]
    buffer, are later speed steps.

Both take open intervals on f32 with no arithmetic, so they are exact:
NaN points and empty boxes (xmin > xmax) never match.  ``ops.bbox_mask``
/ ``ops.bbox_count_select`` are the public API (backend dispatch).
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

"""Segment reduction for per-block aggregation (port of
src/repro/kernels/segment.py; DESIGN.md §16).  Kernel:
``csrc/segment.cu``.

``segment_reduce_sorted`` replaces the Pallas ``segment_reduce_sorted``
(src/repro/kernels/segment.py:83): per segment ``s`` in [0, S), the
count, sum, min and max of the values whose (sorted) id is ``s``.  The
Pallas kernel matches [bp] row tiles against [bs] segment tiles with a
one-hot compare, O(N * S) work; on the card the sort makes each segment
one contiguous run, found by binary search, so the work is O(N + S log
N).  What bounds it: reading the values, 4 bytes a row (the ids are
only binary-searched), and 16 bytes per segment out; with no values
(occupancy counts) only the searches and the output.  Design (see the
source): the runs are
cut into fixed 4,096-row tiles, one block each, so a hot segment is
spread over many blocks; a fixup pass folds the partials of segments
that span tiles.  Every sum is taken in an order fixed by the segment's
bounds and no float atomics are used, so two launches give bit-equal
results.

``ops.segment_reduce`` is the public API: it parks invalid ids at
``n_segments``, stable-sorts on the device, calls this wrapper and
normalizes empty segments.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, ref


def segment_reduce_sorted(ids: torch.Tensor, values: Optional[torch.Tensor],
                          n_segments: int):
    """Per-segment (count [S] i32, sum [S] f32, min [S] f32, max [S] f32)
    of [N] f32 ``values`` grouped by [N] i32 ``ids``; ``values=None`` is
    a zero column, which the kernel never reads (occupancy counts).

    ``ids`` must be sorted ascending.  Rows whose id lies outside [0,
    n_segments) land in no segment (the caller parks invalid ids at
    ``n_segments``).  Empty segments come back (0, 0.0, +inf, -inf).
    CPU tensors go to the plain twin; CUDA tensors launch the kernel on
    the current stream, without synchronizing.
    """
    if ids.device.type == "cpu":
        return ref.segment_reduce(ids, values, n_segments)
    dev = ids.device
    n = ids.shape[0]
    _build.require(ids, "ids", torch.int32, (n,), dev)
    if values is not None:
        _build.require(values, "values", torch.float32, (n,), dev)
    if n_segments < 0 or n >= 2**31 or n_segments >= 2**31 - 1:
        raise ValueError(f"segment_reduce_sorted: {n} rows / {n_segments} "
                         f"segments out of range")
    count = torch.empty(n_segments, dtype=torch.int32, device=dev)
    total = torch.empty(n_segments, dtype=torch.float32, device=dev)
    vmin = torch.empty(n_segments, dtype=torch.float32, device=dev)
    vmax = torch.empty(n_segments, dtype=torch.float32, device=dev)
    if n_segments == 0:
        return count, total, vmin, vmax
    lib = _build.load()
    tile = lib.repro_segment_tile_rows()
    start = torch.empty(n_segments + 1, dtype=torch.int64, device=dev)
    partials = None if values is None else torch.empty(
        ((n + tile - 1) // tile, 2, 3), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        status = lib.repro_segment_reduce_sorted(
            _build.ptr(ids), _build.ptr_or_null(values), _build.ptr(start),
            _build.ptr_or_null(partials), _build.ptr(count),
            _build.ptr(total),
            _build.ptr(vmin), _build.ptr(vmax), n, n_segments,
            _build.stream_of(ids))
    _build.check(status, "segment_reduce_sorted")
    return count, total, vmin, vmax

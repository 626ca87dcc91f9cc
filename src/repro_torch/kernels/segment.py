"""Segment reduction for per-block aggregation (port of
src/repro/kernels/segment.py; DESIGN.md §16).  Kernel:
``csrc/segment.cu``.

``segment_reduce_sorted`` replaces the Pallas ``segment_reduce_sorted``
(src/repro/kernels/segment.py:83): per segment ``s`` in [0, S), the
count, sum, min and max of the values whose (sorted) id is ``s``.  The
Pallas kernel matches [bp] row tiles against [bs] segment tiles with a
one-hot compare, O(N * S) work; on the card the sort makes each segment
one contiguous run, found by a search, so the work is O(N + S log N).
What bounds it: reading the values, 4 bytes a row (the ids are only
searched), and 16 bytes per segment out; with no values (occupancy
counts) only the searches' latency and the launch remain.  Design (see
the source): a warp finds a bound with a 33-way search (5 dependent
rounds at 2^24 rows, where a binary search takes 24).  Counts are one launch that searches into shared memory and
writes.  With values, a
bounds launch, then a launch of 8,192-row tiles that starts while the
first still runs (programmatic dependent launch): each warp copies its
2,048 rows into shared memory with 16-byte asynchronous copies and
reduces the segments there; a segment that crosses tiles leaves a
partial in each, and the tile that gives its last partial (an integer
ticket a segment) folds them in tile order.  Every sum is taken in an
order fixed by the segment's bounds and no float atomics are used, so
two launches give bit-equal results, and a column that does not start
on a 16-byte boundary sums in the same order as an aligned copy.

``ops.segment_reduce`` is the public API: it parks invalid ids at
``n_segments``, stable-sorts on the device, calls this wrapper and
normalizes empty segments.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, ref


def scratch_shapes(n: int, n_segments: int, tile_rows: int,
                   with_values: bool) -> dict:
    """Shapes of the kernel's scratch for ``n`` rows and ``n_segments``
    segments at ``tile_rows`` rows a tile: none for counts (the bounds
    stay in shared memory); with values ``start`` [S + 1] i64,
    ``partials`` [tiles, 2, 3] f32 (each tile's two partials) and
    ``tickets`` [S] i32 (each segment's count of partials given), tiles =
    ceil(n / tile_rows).  An empty column (n = 0) is counts alone."""
    if not with_values or n == 0:
        return {}
    tiles = -(-n // tile_rows)
    return {"start": ((n_segments + 1,), torch.int64),
            "partials": ((tiles, 2, 3), torch.float32),
            "tickets": ((n_segments,), torch.int32)}


def check_args(ids: torch.Tensor, values: Optional[torch.Tensor],
               n_segments: int) -> None:
    """Raise unless the kernel takes these arguments: contiguous [N] i32
    ids and [N] f32 values (or None) on one device, N < 2^31 and 0 <= S <
    2^31 - 1."""
    dev = ids.device
    n = ids.shape[0] if ids.dim() == 1 else -1
    _build.require(ids, "ids", torch.int32, (n,), dev)
    if values is not None:
        _build.require(values, "values", torch.float32, (n,), dev)
    if n_segments < 0 or n >= 2**31 or n_segments >= 2**31 - 1:
        raise ValueError(f"segment_reduce_sorted: {n} rows / {n_segments} "
                         f"segments out of range")


def segment_reduce_sorted(ids: torch.Tensor, values: Optional[torch.Tensor],
                          n_segments: int):
    """Per-segment (count [S] i32, sum [S] f32, min [S] f32, max [S] f32)
    of [N] f32 ``values`` grouped by [N] i32 ``ids``; ``values=None`` is
    a zero column, which the kernel never reads (occupancy counts).

    ``ids`` must be sorted ascending.  Rows whose id lies outside [0,
    n_segments) land in no segment (the caller parks invalid ids at
    ``n_segments``).  Empty segments come back (0, 0.0, +inf, -inf).
    CPU and meta tensors go to the plain twin; CUDA tensors launch the
    kernel on the current stream, without synchronizing: one launch
    without values (or with an empty column), two with
    (``_build.LAUNCHES`` counts each).
    """
    if ids.device.type != "cuda":
        return ref.segment_reduce(ids, values, n_segments)
    dev = ids.device
    check_args(ids, values, n_segments)
    n = ids.shape[0]
    count = torch.empty(n_segments, dtype=torch.int32, device=dev)
    total = torch.empty(n_segments, dtype=torch.float32, device=dev)
    vmin = torch.empty(n_segments, dtype=torch.float32, device=dev)
    vmax = torch.empty(n_segments, dtype=torch.float32, device=dev)
    if n_segments == 0:
        return count, total, vmin, vmax
    if n == 0:
        values = None              # an empty column: counts alone (1 launch)
    lib = _build.load()
    scratch = {name: torch.empty(shape, dtype=dtype, device=dev)
               for name, (shape, dtype) in scratch_shapes(
                   n, n_segments, lib.repro_segment_tile_rows(),
                   values is not None).items()}
    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        status = lib.repro_segment_reduce_sorted(
            _build.ptr(ids), _build.ptr_or_null(values),
            *(_build.ptr_or_null(scratch.get(k))
              for k in ("start", "partials", "tickets")),
            _build.ptr(count), _build.ptr(total), _build.ptr(vmin),
            _build.ptr(vmax), n, n_segments, _build.stream_of(ids),
            ctypes.byref(launched))
    _build.check(status, "segment_reduce_sorted", launches=launched.value)
    return count, total, vmin, vmax

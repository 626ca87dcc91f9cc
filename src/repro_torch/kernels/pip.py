"""Crossing-number point-in-polygon over dense edge tables (port of
src/repro/kernels/pip.py).  Kernels: ``csrc/pip.cu``.

  * ``crossings_gathered`` replaces the Pallas ``crossings_gathered``
    (src/repro/kernels/pip.py:113): each point against its own edge
    table.  What bounds it on the card: reading the gathered [N, E, 4]
    f32 edge table, 16 bytes per edge for a handful of compares and
    products — memory, by a wide margin.  Design: the natural [N, E, 4]
    layout (no transpose to the TPU's [N, 4, E] lane layout, no padding
    to tile multiples); one warp per row, lane j loads edge j as one
    16-byte vector, so a warp reads its row contiguously; warp-shuffle
    sum.
  * ``crossings_one`` replaces the Pallas ``crossings_one``
    (src/repro/kernels/pip.py:86): every point against one shared
    [E, 4] table.  What bounds it: the crossing tests, 6 fp32 operations
    per (point, edge) against 12 bytes per point in and out.  The first
    design (one point a thread, ``crosses()`` on each raw staged edge)
    spent ~15-20 instruction slots a test, recomputing each edge's own terms
    for every point.  Design: each block stages the table in 256-edge
    tiles in shared memory as precomputed terms (x1, y1, x2 - x1,
    y2 - y1, y2, y2 > y1; the same IEEE operations, so bit-equal),
    dropping the edges with y1 == y2, which never straddle; each thread
    holds 4 points in registers, so every shared-memory load of an edge
    serves 4 tests, and a test is two subtractions, two products, three
    compares and the logic (~11 instructions in its SASS, so it runs at
    the instruction rate, about a quarter of the fp32 bound;
    scripts/crossings_one_variants.py).  E = 0 writes 0.

``ops.pip_gathered`` / ``ops.pip_one`` are the public API (parity ->
bool, backend dispatch).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref


def crossings_gathered(points: torch.Tensor,
                       edges: torch.Tensor) -> torch.Tensor:
    """Crossing counts where each of N [N, 2] f32 points brings its own
    [E, 4] f32 edge table (``edges`` [N, E, 4]).  Returns [N] i32.

    CPU and meta tensors go to the plain twin; CUDA tensors launch the
    kernel on the current stream, without synchronizing.
    """
    if points.device.type != "cuda":
        return ref.crossings_gathered(points, edges)
    dev = points.device
    n = points.shape[0]
    _build.require(points, "points", torch.float32, (n, 2), dev)
    _build.require(edges, "edges", torch.float32, (n, None, 4), dev)
    _build.require_aligned(edges, "edges", 16)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(dev):
        status = lib.repro_crossings_gathered(
            _build.ptr(points), _build.ptr(edges), _build.ptr(out), n,
            edges.shape[1], _build.stream_of(points))
    _build.check(status, "crossings_gathered")
    return out


def crossings_one(points: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """Crossing counts of [N, 2] f32 points against one shared [E, 4] f32
    edge table.  Returns [N] i32.

    CPU and meta tensors go to the plain twin; CUDA tensors launch the
    kernel on the current stream, without synchronizing.
    """
    if points.device.type != "cuda":
        return ref.crossings_one(points, edges)
    dev = points.device
    n = points.shape[0]
    _build.require(points, "points", torch.float32, (n, 2), dev)
    _build.require(edges, "edges", torch.float32, (None, 4), dev)
    _build.require_aligned(points, "points", 8)
    _build.require_aligned(edges, "edges", 16)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(dev):
        status = lib.repro_crossings_one(
            _build.ptr(points), _build.ptr(edges), _build.ptr(out), n,
            edges.shape[0], _build.stream_of(points))
    _build.check(status, "crossings_one")
    return out

"""Crossing-number point-in-polygon over per-point edge tables (port of
src/repro/kernels/pip.py::crossings_gathered).

Kernel: ``csrc/pip.cu``, replacing the Pallas ``crossings_gathered``
(src/repro/kernels/pip.py:113).  What bounds it on the card: reading the
gathered [N, E, 4] f32 edge table, 16 bytes per edge for a handful of
compares and products — memory, by a wide margin.  Design: the natural
[N, E, 4] layout (no transpose to the TPU's [N, 4, E] lane layout, no
padding to tile multiples); one warp per row, lane j loads edge j as one
16-byte vector, so a warp reads its row contiguously; warp-shuffle sum.

``ops.pip_gathered`` is the public API (parity -> bool, backend
dispatch).  ``crossings_one`` (the shared-table kernel) is not ported
yet.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref


def crossings_gathered(points: torch.Tensor,
                       edges: torch.Tensor) -> torch.Tensor:
    """Crossing counts where each of N [N, 2] f32 points brings its own
    [E, 4] f32 edge table (``edges`` [N, E, 4]).  Returns [N] i32.

    CPU tensors go to the plain twin; CUDA tensors launch the kernel on
    the current stream, without synchronizing.
    """
    if points.device.type == "cpu":
        return ref.crossings_gathered(points, edges)
    dev = points.device
    n = points.shape[0]
    _build.require(points, "points", torch.float32, (n, 2), dev)
    _build.require(edges, "edges", torch.float32, (n, None, 4), dev)
    if edges.data_ptr() % 16:
        raise ValueError("edges must be 16-byte aligned (float4 loads)")
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

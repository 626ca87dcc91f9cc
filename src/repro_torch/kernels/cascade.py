"""One-pass fused cascade: quantize -> Morton/cell lookup -> bbox filter
-> point-in-polygon in one kernel (port of src/repro/kernels/cascade.py).

Per point: quantize and Morton-interleave to a leaf code; find the
covering cell (top-grid bucket, then a fixed-iteration binary search
over ``cell_lo``); an interior cell gives the block id at once, a
boundary cell walks its <= K candidate slots in order — a candidate whose
bbox strictly excludes the point is skipped without reading its edges,
otherwise its edge-pool blocks are crossing-tested.  The first odd count
wins; no match falls back to the slot-0 centre owner.

Outputs (all [N] i32; ``ops.assign_cascade`` is the public dispatch):
``bid`` (-1 = off map / no cell / no candidate), ``flags`` (bit 0:
boundary-cell hit, bit 1: resolved by slot 0), ``nrest`` (valid
candidates in slots 1..K-1) and ``nskip`` (slots the bbox filter
rejected before any edge was read).

Kernel: ``csrc/cascade.cu``, replacing the Pallas ``assign_cascade``
(src/repro/kernels/cascade.py:224).  What bounds it on the card: the
point stream through HBM (8 bytes in, 16 out per point); the cell tables
and the pool are a few MB and stay in L2.  Most points are interior, and
their cost is the chain of dependent L2 reads of the bucket and the
binary search, a latency that only many points in flight hide; then the
boundary points' edge tests over padded BE-edge pool blocks (BE = 256),
also read from L2.  Design: one thread per point for the locate, so every
resident thread has a search in flight; interior, off-extent and no-cell
points write their outputs at once; boundary points go into a queue in
shared memory (ballot + popc + one counter per block), which the block's
warps then drain one point per warp, the lanes sharing each candidate's
BE edges (a warp-uniform walk, reduced with a warp shuffle).  The TPU's
double-buffered DMA becomes plain loads through L1/L2.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build

# Sentinel cell value for "off extent / no covering cell" (core.fast
# re-exports it).
OUTSIDE = -2**30


def part1by1(x):
    """Spread the low 16 bits of ``x`` over the even bit positions."""
    x = x & 0x0000FFFF
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    x = (x | (x << 1)) & 0x55555555
    return x


def morton(ix, iy):
    return (part1by1(iy) << 1) | part1by1(ix)


def effective_iters(n_cells: int, gbits: int, search_iters: int) -> int:
    """Binary-search iteration count for the cell locate.  With a top
    grid (gbits > 0) the index's recorded per-bucket bound applies;
    without one the search spans the whole table: log2(n_cells)."""
    if gbits > 0:
        return max(1, int(search_iters))
    return max(1, int(np.ceil(np.log2(max(int(n_cells), 2)))))


def assign_cascade(points, quant, cell_lo, cell_hi, cell_val, top_start,
                   cand, bbox, first, count, blocks, *, max_level: int,
                   gbits: int, search_iters: int):
    """One-pass cascade over [N, 2] f32 points -> (bid, flags, nrest,
    nskip), each [N] i32.

    Inputs must be well formed (``ops.assign_cascade`` normalizes empty
    tables): ``cand`` [B>=1, K>=1] i32, ``bbox`` [P, 4] f32 aligned with
    ``first``/``count`` [P>=1] i32, ``blocks`` [NB, 4, BE] f32, and
    ``search_iters`` already ``effective_iters``-normalized.  CPU and meta
    tensors go to the plain twin (``ref.assign_cascade``); CUDA tensors
    launch the kernel on the current stream, without synchronizing.
    """
    if points.device.type != "cuda":
        from repro_torch.kernels import ref   # ref imports this module
        max_blocks = max(int(count.max()), 1) if count.numel() else 1
        return ref.assign_cascade(
            points, quant, cell_lo, cell_hi, cell_val, top_start, cand,
            bbox, first, count, blocks, max_level=max_level, gbits=gbits,
            search_iters=search_iters, max_blocks=max_blocks)
    dev = points.device
    f32, i32 = torch.float32, torch.int32
    n, n_cells = points.shape[0], cell_lo.shape[0]
    b, k = cand.shape
    p = first.shape[0]
    for t, name, dtype, shape in (
            (points, "points", f32, (None, 2)), (quant, "quant", f32, (4,)),
            (cell_lo, "cell_lo", i32, (n_cells,)),
            (cell_hi, "cell_hi", i32, (n_cells,)),
            (cell_val, "cell_val", i32, (n_cells,)),
            (top_start, "top_start", i32, ((1 << 2 * gbits) + 1,)),
            (cand, "cand", i32, (b, k)), (bbox, "bbox", f32, (p, 4)),
            (first, "first", i32, (p,)), (count, "count", i32, (p,)),
            (blocks, "blocks", f32, (None, 4, None))):
        _build.require(t, name, dtype, shape, dev)
    _build.require_aligned(points, "points", 8)
    if n_cells < 1 or b < 1 or k < 1 or p < 1:
        raise ValueError("assign_cascade needs non-empty cell, candidate "
                         "and polygon tables (ops.assign_cascade pads them)")
    outs = tuple(torch.empty(n, dtype=i32, device=dev) for _ in range(4))
    if n == 0:
        return outs
    lib = _build.load()
    with torch.cuda.device(dev):
        status = lib.repro_assign_cascade(
            *(_build.ptr(t) for t in (points, quant, cell_lo, cell_hi,
                                      cell_val, top_start, cand, bbox,
                                      first, count, blocks) + outs),
            n, max_level, gbits, search_iters, k, n_cells, b, p,
            blocks.shape[2], _build.stream_of(points))
    _build.check(status, "assign_cascade")
    return outs

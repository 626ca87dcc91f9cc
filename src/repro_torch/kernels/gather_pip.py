"""Candidate PIP over a blocked-CSR edge pool: candidate ids in, crossing
counts out (port of src/repro/kernels/gather_pip.py).

Data layout (``EdgePool``, packed by ``build_edge_pool`` on the device
of the edges it is given):

  * ``blocks [NB, 4, BE]`` f32 — every polygon's non-degenerate edges
    packed struct-of-arrays (x1/y1/x2/y2 rows of BE edges), zero-padded
    to whole blocks.  Block 0 is reserved all-zero: zero-length edges
    give no crossings, so it is the "no candidate" target;
  * ``first [P]`` / ``count [P]`` i32 — CSR row pointers in block units:
    polygon ``p`` owns blocks ``first[p] .. first[p]+count[p]-1``;
  * ``live [P]`` i32 — polygon ``p``'s live edges, at positions
    ``0 .. live[p]-1`` of its blocks (edge ``i`` at block
    ``first + i // BE``, lane ``i % BE``).  ``blocks`` / ``first`` /
    ``count`` are array-equal to the JAX package's pool; ``live`` is the
    port's own.  The one-pass cascade (``csrc/cascade.cu``) does not read
    it yet.

Kernel: ``csrc/gather_pip.cu``, replacing the Pallas
``crossings_candidates`` (src/repro/kernels/gather_pip.py:151).  What
bounds it on the card: the rows' own bytes (12 in, 4 out); the census's
block polygons have 4-14 live edges (8.2 on average) in 256-edge blocks,
so the tests are few once the padding is skipped, and a polygon's edges
stay in L1 / L2 for all its rows.  Design: one thread a row, walking its
candidate's live edges and stopping at the last one; the caller's
candidate-id sort (core/resolve.py ``_pip_ids``) makes the threads of a
warp share a polygon, so each edge load is a broadcast.  The kernel
reads ``first`` / ``count`` / ``live`` by id itself, so the caller
gathers no per-row ranges.  A row without a candidate writes 0.

``ops.pip_candidates`` is the public API (parity -> bool, backend
dispatch).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels import _build, ref

# Edges per pool block (the reference's lane-axis width).
DEF_BE = 256


@dataclasses.dataclass
class EdgePool:
    """Blocked-CSR edge pool (see module docstring for the layout)."""

    blocks: torch.Tensor     # [NB, 4, BE] f32 — block 0 reserved all-zero
    first: torch.Tensor      # [P] i32 — first pool block of polygon p
    count: torch.Tensor      # [P] i32 — pool blocks owned by polygon p
    live: torch.Tensor       # [P] i32 — live edges of polygon p
    max_blocks: int = 1
    be: int = DEF_BE

    @property
    def n_poly(self) -> int:
        return self.first.shape[0]

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.blocks, self.first, self.count, self.live))

    @classmethod
    def from_numpy(cls, blocks, first, count, device="cuda") -> "EdgePool":
        """A pool from host arrays (e.g. one packed by the JAX package);
        ``live``, ``max_blocks`` and ``be`` follow from them
        (``live_from_blocks``).  The tensors are copies."""
        blocks, first, count = (np.array(a) for a in (blocks, first, count))
        live = live_from_blocks(blocks, first, count)
        return cls(blocks=torch.as_tensor(blocks, device=device),
                   first=torch.as_tensor(first, device=device),
                   count=torch.as_tensor(count, device=device),
                   live=torch.as_tensor(live, device=device),
                   max_blocks=max(int(count.max()) if count.size else 1, 1),
                   be=int(blocks.shape[2]))


def live_from_blocks(blocks: np.ndarray, first: np.ndarray,
                     count: np.ndarray) -> np.ndarray:
    """[P] i32 live-edge counts of a packed pool: one more than the last
    position in polygon p's blocks whose edge is not all-zero (0 if none).
    Exact for a pool packed by ``build_edge_pool`` (here or in the JAX
    package): live edges sit at positions 0 .. n-1 and are never all-zero
    (an all-zero edge is zero-length, and those are dropped)."""
    blocks = np.asarray(blocks, np.float32)
    first = np.asarray(first, np.int64)
    count = np.asarray(count, np.int64)
    be = blocks.shape[2]
    live = np.zeros(first.shape[0], np.int64)
    if not count.sum():
        return live.astype(np.int32)
    nz = (blocks != 0).any(axis=1)                          # [NB, BE]
    # One past each block's last non-zero lane (0 for an empty block).
    end = np.where(nz.any(axis=1), be - np.argmax(nz[:, ::-1], axis=1), 0)
    owner = np.repeat(np.arange(first.shape[0]), count)
    rank = np.arange(owner.shape[0]) - np.repeat(np.cumsum(count) - count,
                                                 count)    # block in poly
    blk_end = end[first[owner] + rank]
    np.maximum.at(live, owner, np.where(blk_end > 0,
                                        rank * be + blk_end, 0))
    return live.astype(np.int32)


def build_edge_pool(edges, be: int = DEF_BE, device=None) -> EdgePool:
    """Pack a dense ``[P, E, 4]`` edge table into a blocked-CSR EdgePool.
    Degenerate (zero-length) padding edges are dropped; a polygon with
    ``e`` live edges owns ``ceil(e / be)`` blocks and ``live`` is its
    ``e``.  The packing runs in torch on ``device``: by default the
    device of a tensor ``edges``, and "cuda" for a host array.  Its
    ``blocks`` / ``first`` / ``count`` are array-equal to the JAX
    package's host packing."""
    if device is None:
        device = edges.device if isinstance(edges, torch.Tensor) else "cuda"
    if not isinstance(edges, torch.Tensor):
        edges = torch.from_numpy(np.array(edges, np.float32))
    e = edges.to(device=device, dtype=torch.float32)
    p = e.shape[0]
    live = (e[..., 0] != e[..., 2]) | (e[..., 1] != e[..., 3])  # [P, E]
    n_live = live.sum(dim=1)                                    # i64
    count = (n_live + be - 1) // be
    first = 1 + torch.cumsum(count, 0) - count   # block 0 is reserved
    n_blocks, max_blocks = (int(v) for v in torch.stack(
        [count.sum(), count.max()]).tolist()) if p else (0, 1)
    blocks = torch.zeros((1 + n_blocks, 4, be), dtype=torch.float32,
                         device=device)
    el = e[live]                                 # [total, 4] poly-major
    if el.shape[0]:
        # Each live edge's (block, lane) follows from its rank within
        # its polygon; destinations are unique.
        poly_of = torch.repeat_interleave(
            torch.arange(p, device=device), n_live,
            output_size=el.shape[0])
        starts = torch.cumsum(n_live, 0) - n_live
        pos = torch.arange(el.shape[0], device=device) - starts[poly_of]
        blocks[first[poly_of] + pos // be, :, pos % be] = el
    return EdgePool(blocks=blocks, first=first.int(), count=count.int(),
                    live=n_live.int(), max_blocks=max(max_blocks, 1), be=be)


def crossings_candidates(pids: torch.Tensor, points: torch.Tensor,
                         first: torch.Tensor, count: torch.Tensor,
                         live: torch.Tensor, blocks: torch.Tensor,
                         max_blocks: int = 1) -> torch.Tensor:
    """Crossing counts of [R, 2] f32 points vs the live edges of their
    own candidate polygons ``pids`` [R] i32 (< 0: no candidate, count 0;
    ids past the table clamp to its last polygon, as ``ops`` clamps
    them), read from a pool's ``first`` / ``count`` / ``live`` [P >= 1]
    i32 and ``blocks``.  Returns [R] i32.

    CPU and meta tensors go to the plain twin
    (``ref.crossings_candidates``, the same arguments); CUDA tensors
    launch the kernel on the current stream, without synchronizing.
    """
    if points.device.type != "cuda":
        return ref.crossings_candidates(pids, points, first, count, live,
                                        blocks, max_blocks)
    dev = points.device
    r, p = points.shape[0], first.shape[0]
    for t, name, dtype, shape in (
            (pids, "pids", torch.int32, (r,)),
            (points, "points", torch.float32, (r, 2)),
            (first, "first", torch.int32, (p,)),
            (count, "count", torch.int32, (p,)),
            (live, "live", torch.int32, (p,)),
            (blocks, "blocks", torch.float32, (None, 4, None))):
        _build.require(t, name, dtype, shape, dev)
    _build.require_aligned(points, "points", 8)
    if p < 1:
        raise ValueError("crossings_candidates needs a non-empty polygon "
                         "table (ops.pip_candidates handles an empty one)")
    out = torch.empty(r, dtype=torch.int32, device=dev)
    if r == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(dev):
        status = lib.repro_crossings_candidates(
            *(_build.ptr(t) for t in (pids, points, first, count, live,
                                      blocks, out)),
            r, p, blocks.shape[2], _build.stream_of(points))
    _build.check(status, "crossings_candidates")
    return out

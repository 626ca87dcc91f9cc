"""Candidate PIP over a blocked-CSR edge pool: candidate ids in, crossing
counts out (port of src/repro/kernels/gather_pip.py).

Data layout (``EdgePool``, built on the host by ``build_edge_pool``):

  * ``blocks [NB, 4, BE]`` f32 — every polygon's non-degenerate edges
    packed struct-of-arrays (x1/y1/x2/y2 rows of BE edges), zero-padded
    to whole blocks.  Block 0 is reserved all-zero: zero-length edges
    give no crossings, so it is the "no candidate" target;
  * ``first [P]`` / ``count [P]`` i32 — CSR row pointers in block units:
    polygon ``p`` owns blocks ``first[p] .. first[p]+count[p]-1``.

Kernel: ``csrc/gather_pip.cu``, replacing the Pallas
``crossings_candidates`` (src/repro/kernels/gather_pip.py:151).  What
bounds it on the card: the crossing tests, BE per owned block per row
(the blocks are zero-padded, so a small polygon still costs a whole
block); the per-row inputs are 20 bytes and the pool stays in L2.
Design: one warp per row, lanes over the block's BE edges, warp-shuffle
sum; a row with ``nblk == 0`` writes 0 without loading.  The caller's
candidate-id sort (core/resolve.py ``_pip_ids``) puts rows that read the
same blocks next to each other, so L2 serves the repeats the TPU kernel
skipped by revisiting its VMEM block.

``ops.pip_candidates`` is the public API (id masking, parity -> bool,
backend dispatch).
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
    max_blocks: int = 1
    be: int = DEF_BE

    @property
    def n_poly(self) -> int:
        return self.first.shape[0]

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.blocks, self.first, self.count))

    @classmethod
    def from_numpy(cls, blocks, first, count, device="cuda") -> "EdgePool":
        """A pool from host arrays (e.g. one packed by the JAX package);
        ``max_blocks`` and ``be`` follow from them.  The tensors are
        copies."""
        count = np.array(count)
        blocks = torch.as_tensor(np.array(blocks), device=device)
        return cls(blocks=blocks,
                   first=torch.as_tensor(np.array(first), device=device),
                   count=torch.as_tensor(count, device=device),
                   max_blocks=max(int(count.max()) if count.size else 1, 1),
                   be=int(blocks.shape[2]))


def build_edge_pool(edges: np.ndarray, be: int = DEF_BE,
                    device="cuda") -> EdgePool:
    """Pack a dense ``[P, E, 4]`` edge table into a blocked-CSR EdgePool
    on ``device``.  Degenerate (zero-length) padding edges are dropped; a
    polygon with ``e`` live edges owns ``ceil(e / be)`` blocks.  The
    packing is host numpy, array-equal to the reference's."""
    e = np.asarray(edges, np.float32)
    p = e.shape[0]
    live = ~((e[..., 0] == e[..., 2]) & (e[..., 1] == e[..., 3]))
    n_live = live.sum(axis=1).astype(np.int64) if p else np.zeros(0, np.int64)
    count = np.ceil(n_live / be).astype(np.int32)
    first = np.ones(p, np.int32)                 # block 0 is reserved
    if p:
        first[1:] += np.cumsum(count)[:-1].astype(np.int32)
    nb = 1 + int(count.sum())
    blocks = np.zeros((nb, 4, be), np.float32)
    if p and n_live.sum():
        # e[live] is polygon-major, so each live edge's (block, lane)
        # destination follows from its rank within its polygon.
        el = e[live]                                        # [total, 4]
        poly_of = np.repeat(np.arange(p), n_live)
        starts = np.concatenate([[0], np.cumsum(n_live)[:-1]])
        pos = np.arange(len(el)) - starts[poly_of]          # rank in poly
        blk = first[poly_of] + pos // be
        blocks[blk, :, pos % be] = el
    return EdgePool(blocks=torch.as_tensor(blocks, device=device),
                    first=torch.as_tensor(first, device=device),
                    count=torch.as_tensor(count, device=device),
                    max_blocks=max(int(count.max()) if p else 1, 1), be=be)


def crossings_candidates(first: torch.Tensor, nblk: torch.Tensor,
                         points: torch.Tensor, blocks: torch.Tensor,
                         max_blocks: int = 1) -> torch.Tensor:
    """Crossing counts of [R, 2] f32 points vs their own pool slices.

    ``first``/``nblk`` [R] i32 are per-row block ranges (``ops`` resolves
    them from candidate ids; nblk == 0 means no candidate).  Returns [R]
    i32.  CPU tensors go to the plain twin; CUDA tensors launch the
    kernel on the current stream, without synchronizing.
    """
    if points.device.type == "cpu":
        return ref.crossings_candidates(points, first, nblk, blocks,
                                        max_blocks)
    dev = points.device
    r = points.shape[0]
    for t, name, dtype, shape in (
            (first, "first", torch.int32, (r,)),
            (nblk, "nblk", torch.int32, (r,)),
            (points, "points", torch.float32, (r, 2)),
            (blocks, "blocks", torch.float32, (None, 4, None))):
        _build.require(t, name, dtype, shape, dev)
    out = torch.empty(r, dtype=torch.int32, device=dev)
    if r == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(dev):
        status = lib.repro_crossings_candidates(
            _build.ptr(first), _build.ptr(nblk), _build.ptr(points),
            _build.ptr(blocks), _build.ptr(out), r, blocks.shape[2],
            _build.stream_of(points))
    _build.check(status, "crossings_candidates")
    return out

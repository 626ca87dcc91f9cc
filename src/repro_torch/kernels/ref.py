"""Plain PyTorch twins of the hand-written kernels.

Each function here is written op for op as its counterpart in
src/repro/kernels/ref.py, so on the same inputs it gives bit-equal
results.  The twins are the CPU backend (``ops`` picks them for CPU
tensors), what the CPU tests hold against the JAX reference, and what
chip_smoke.py holds each CUDA kernel against on the card.
``bbox_mask_gathered`` has no kernel: it is a torch op on every
backend, as in the reference.  ``bbox_select_children`` has no
counterpart there: it is the cascade's county and block bbox step as
``core/simple.py`` composed it from the functions here.
``np_segment_reduce`` is the numpy ground truth of the segment
reduction (a copy of the reference's).
``flash_attn_bhsd`` has no counterpart in src/repro/kernels/ref.py: it
is the plain form of the Pallas flash kernel itself (see its doc).

Crossing-number test (paper §III-A): a point is inside a polygon iff a
ray in +x crosses the boundary an odd number of times.  Edge
(x1,y1)-(x2,y2) is crossed iff it straddles the point's y (half-open
rule ``(y1 > py) != (y2 > py)``) and the intersection lies right of the
point, tested without division as

    (px - x1) * (y2 - y1)  <  (py - y1) * (x2 - x1)      [sign-adjusted]
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.cascade import OUTSIDE, morton


def _cross(px, py, x1, y1, x2, y2):
    straddle = (y1 > py) != (y2 > py)
    lhs = (px - x1) * (y2 - y1)
    rhs = (py - y1) * (x2 - x1)
    return straddle & ((lhs < rhs) == (y2 > y1))


def crossings_one(points: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """Crossing counts of N points against one shared edge table.

    points [N, 2] float, edges [E, 4] float (x1, y1, x2, y2; zero-length
    edges never cross) -> [N] int32.
    """
    px = points[:, 0:1]
    py = points[:, 1:2]
    cross = _cross(px, py, edges[None, :, 0], edges[None, :, 1],
                   edges[None, :, 2], edges[None, :, 3])
    return cross.sum(dim=1, dtype=torch.int32)


def pip_one(points: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """Inside mask of N points against one polygon edge table."""
    return (crossings_one(points, edges) & 1).bool()


def crossings_gathered(points: torch.Tensor,
                       edges: torch.Tensor) -> torch.Tensor:
    """Crossing counts where each point has its own edge table.

    points [N, 2] float, edges [N, E, 4] float -> [N] int32.
    """
    px = points[:, 0:1]
    py = points[:, 1:2]
    cross = _cross(px, py, edges[..., 0], edges[..., 1], edges[..., 2],
                   edges[..., 3])
    return cross.sum(dim=1, dtype=torch.int32)


def pip_gathered(points: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    return (crossings_gathered(points, edges) & 1).bool()


def crossings_pool(points: torch.Tensor, first: torch.Tensor,
                   count: torch.Tensor, blocks: torch.Tensor,
                   max_blocks: int,
                   live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Crossing counts of each point against its own pool block range
    (the reference's ``crossings_candidates``, op for op).

    points [N, 2] float; first/count [N] i32 — each point's pool block
    range (count 0 = no candidate); blocks [NB, 4, BE] float with block 0
    all-zero (the masked-gather target); max_blocks the max of ``count``
    over the pool.  ``live`` [N] i32, if given, also masks the edges at
    positions >= live in the range (position = block * BE + lane); with
    ``live = count * BE`` it masks nothing.  Returns [N] int32.
    """
    b = torch.arange(max_blocks, dtype=torch.int32,
                     device=points.device)[None, :]
    ix = torch.where(b < count[:, None], first[:, None] + b, 0)
    g = blocks[ix.clamp(0, blocks.shape[0] - 1)]        # [N, MAXB, 4, BE]
    px = points[:, 0][:, None, None]
    py = points[:, 1][:, None, None]
    cross = _cross(px, py, g[:, :, 0], g[:, :, 1], g[:, :, 2], g[:, :, 3])
    if live is not None:
        be = blocks.shape[2]
        pos = (b[:, :, None] * be
               + torch.arange(be, dtype=torch.int32,
                              device=points.device)[None, None, :])
        cross = cross & (pos < live[:, None, None])
    return cross.sum(dim=(1, 2), dtype=torch.int32)


def crossings_candidates(pids: torch.Tensor, points: torch.Tensor,
                         first: torch.Tensor, count: torch.Tensor,
                         live: torch.Tensor, blocks: torch.Tensor,
                         max_blocks: int) -> torch.Tensor:
    """Twin of the candidate-PIP kernel (kernels/gather_pip.py), with its
    arguments: pids [N] i32 candidate polygon ids (< 0: none; clamped
    into [0, P-1] otherwise, as the reference's ``ops`` clamps them),
    points [N, 2], a pool's first / count / live [P] i32 and blocks.
    Resolves each row's block range and live count by id, then
    ``crossings_pool`` with edges at positions >= live masked.  Returns
    [N] int32."""
    valid = pids >= 0
    safe = pids.clamp(0, max(first.shape[0] - 1, 0)).long()
    return crossings_pool(points, torch.where(valid, first[safe], 0),
                          torch.where(valid, count[safe], 0), blocks,
                          max_blocks, live=torch.where(valid, live[safe], 0))


def bbox_mask(points: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """[N, M] int8 membership of N points in M shared boxes (open
    intervals); boxes [M, 4] = (xmin, xmax, ymin, ymax)."""
    px, py = points[:, 0:1], points[:, 1:2]
    m = ((px > boxes[None, :, 0]) & (px < boxes[None, :, 1])
         & (py > boxes[None, :, 2]) & (py < boxes[None, :, 3]))
    return m.to(torch.int8)


def bbox_mask_gathered(points: torch.Tensor,
                       boxes: torch.Tensor) -> torch.Tensor:
    """[N, C] int8 membership where each point has its own C boxes
    [N, C, 4]."""
    px, py = points[:, 0:1], points[:, 1:2]
    m = ((px > boxes[..., 0]) & (px < boxes[..., 1])
         & (py > boxes[..., 2]) & (py < boxes[..., 3]))
    return m.to(torch.int8)


def bbox_count_select(points: torch.Tensor, boxes: torch.Tensor):
    """Membership count and largest containing slot over gathered boxes.

    points [N, 2]; boxes [N, C, 4] (padded boxes empty, xmin > xmax).
    Returns (count [N] i32, sel [N] i32 — the largest containing slot,
    -1 if none; when count == 1 it is *the* containing slot).
    """
    m = bbox_mask_gathered(points, boxes)
    count = m.sum(dim=1, dtype=torch.int32)
    iota = torch.arange(boxes.shape[1], dtype=torch.int32,
                        device=points.device)[None, :]
    sel = torch.where(m != 0, iota, -1).amax(dim=1)
    return count, sel.to(torch.int32)


def bbox_select_children(points: torch.Tensor, parent: torch.Tensor,
                         children_table: torch.Tensor,
                         bbox_table: torch.Tensor, k: int):
    """Twin of the ``bbox_select_children`` kernel: the county and block
    levels' bbox step as the cascade composed it before the kernel — the
    parent's children and their boxes gathered, ``bbox_count_select``,
    the pick, and the first min(k, C) containing slots by ``topk``.

    points [N, 2]; parent [N] i32 (-1 = lost); children_table [P+1, C]
    i32, -1 padded, its last row the sentinel of -1s; bbox_table [M+1, 4]
    f32, its last row the sentinel (empty) box.  A parent outside [0, P)
    reads the sentinel row, a child id outside [0, M) the sentinel box.
    Returns (count [N] i32, pick [N] i32 — the child id of the largest
    containing slot, -1 if none; first [N, min(k, C)] i32 — the child ids
    of the first containing slots in slot order, -1 after them).
    """
    n_parents = children_table.shape[0] - 1
    n_boxes = bbox_table.shape[0] - 1
    parent_ix = torch.where((parent >= 0) & (parent < n_parents), parent,
                            n_parents)
    cand = children_table[parent_ix.long()]                     # [N, C]
    cand_ix = torch.where((cand >= 0) & (cand < n_boxes), cand, n_boxes)
    boxes = bbox_table[cand_ix.long()]                          # [N, C, 4]
    count, sel = bbox_count_select(points, boxes)
    picked = torch.gather(cand, 1, sel.clamp(min=0).long()[:, None])[:, 0]
    pick = torch.where(sel >= 0, picked, -1)
    c = cand.shape[1]
    iota = torch.arange(c, dtype=torch.int32, device=points.device)[None, :]
    score = torch.where(bbox_mask_gathered(points, boxes) != 0, c - iota, 0)
    vals, _ = torch.topk(score, min(k, c), dim=1, sorted=True)
    slots = torch.where(vals > 0, c - vals, -1)          # first k slots
    first = torch.where(slots >= 0,
                        torch.gather(cand, 1, slots.clamp(min=0).long()), -1)
    return count, pick.to(torch.int32), first.to(torch.int32)


def grid_coord(f: torch.Tensor, nmax: int) -> torch.Tensor:
    """Float grid coordinate -> int32 in [0, nmax], clamped BEFORE the
    cast (NaN -> 0).  An off-extent, FAR or NaN coordinate would
    otherwise cast to an arbitrary integer and index the tables out of
    bounds; such points are masked by the extent test, so only the read
    has to stay in bounds.  In-extent values are the same as the JAX
    reference's cast-then-clip; the CUDA kernel clamps the same way."""
    return torch.nan_to_num(f, nan=0.0).clamp(0, nmax).to(torch.int32)


def assign_cascade(points: torch.Tensor, quant: torch.Tensor,
                   cell_lo: torch.Tensor, cell_hi: torch.Tensor,
                   cell_val: torch.Tensor, top_start: torch.Tensor,
                   cand: torch.Tensor, bbox: torch.Tensor,
                   first: torch.Tensor, count: torch.Tensor,
                   blocks: torch.Tensor, *, max_level: int, gbits: int,
                   search_iters: int, max_blocks: int):
    """Twin of the one-pass cascade kernel (kernels/cascade.py): the
    kernel's per-point schedule vectorized — same quantize arithmetic,
    same fixed-iteration cell search, same slot-ordered bbox-gated
    candidate walk.

    Inputs must be normalized as ``ops.assign_cascade`` does (``cand``
    [B>=1, K>=1], ``search_iters`` already ``effective_iters``-adjusted).
    Returns (bid, flags, nrest, nskip), each [N] i32.
    """
    n_cells = cell_lo.shape[0]
    pts = points.float()
    px, py = pts[:, 0], pts[:, 1]
    span = float(1 << max_level)
    fx = (px - quant[0]) * quant[2]
    fy = (py - quant[1]) * quant[3]
    in_ext = (fx >= 0.0) & (fx < span) & (fy >= 0.0) & (fy < span)
    nmax = (1 << max_level) - 1
    code = morton(grid_coord(fx, nmax), grid_coord(fy, nmax))

    if gbits > 0:
        shift = 2 * (max_level - gbits)
        bucket = code >> shift
        l = (top_start[bucket] - 1).clamp(min=0)
        h = top_start[bucket + 1]
    else:
        l = torch.zeros_like(code)
        h = torch.full_like(code, n_cells)
    for _ in range(search_iters):
        active = l < h
        mid = (l + h) // 2
        go_right = cell_lo[mid.clamp(0, n_cells - 1)] <= code
        nl = torch.where(active & go_right, mid + 1, l)
        nh = torch.where(active & ~go_right, mid, h)
        l, h = nl, nh
    cidx = (l - 1).clamp(0, n_cells - 1)
    in_cell = (cell_lo[cidx] <= code) & (code <= cell_hi[cidx]) & in_ext
    v = torch.where(in_cell, cell_val[cidx], OUTSIDE)

    boundary = (v < 0) & (v > OUTSIDE)
    brow = (-(v + 1)).clamp(0, cand.shape[0] - 1)
    n_poly = first.shape[0]
    n = points.shape[0]
    best = torch.full((n,), -1, dtype=torch.int32, device=points.device)
    slot0_hit = torch.zeros(n, dtype=torch.bool, device=points.device)
    nrest = torch.zeros(n, dtype=torch.int32, device=points.device)
    nskip = torch.zeros(n, dtype=torch.int32, device=points.device)
    for s in range(cand.shape[1]):
        pid = cand[brow, s]
        valid = boundary & (pid >= 0)
        if s > 0:
            nrest = nrest + valid.int()
        attempt = valid & (best < 0)
        safe = pid.clamp(0, n_poly - 1)
        bb = bbox[safe]
        inb = ((px > bb[:, 0]) & (px < bb[:, 1])
               & (py > bb[:, 2]) & (py < bb[:, 3]))
        do = attempt & inb
        nskip = nskip + (attempt & ~inb).int()
        nblk = torch.where(do, count[safe], 0)
        cross = crossings_pool(pts, first[safe], nblk, blocks, max_blocks)
        inside = do & ((cross & 1) == 1)
        best = torch.where(inside, pid, best)
        if s == 0:
            slot0_hit = inside

    fb0 = cand[brow, 0]
    fallback = torch.where(fb0 >= 0, fb0, -1)
    resolved = torch.where(best >= 0, best, fallback)
    bid = torch.where(boundary, resolved, torch.where(v >= 0, v, -1))
    flags = boundary.int() | (slot0_hit.int() << 1)
    return bid.int(), flags, nrest, nskip


def segment_reduce(ids: torch.Tensor, values: Optional[torch.Tensor],
                   n_segments: int):
    """Twin of the segment-reduce kernel (kernels/segment.py).

    Rows whose id lies outside [0, n_segments) land in no segment: they
    are parked at the extra scratch segment ``n_segments``, sliced off
    here (``ops.segment_reduce`` parks them before any backend).  The ids
    need not be sorted; ``values=None`` is a zero column.  Returns (count
    [S] i32, sum [S] f32, min [S] f32, max [S] f32); empty segments are
    (0, 0.0, +inf, -inf).  On a CUDA tensor ``index_add_`` adds with
    atomics, so the f32 sum's order (and its rounding) varies from run to
    run; it is exact on integer-valued columns below 2**24.
    """
    dev = ids.device
    ix = torch.where((ids < 0) | (ids > n_segments), n_segments,
                     ids).long()
    values = torch.zeros(ids.shape, device=dev) if values is None \
        else values.float()
    num = n_segments + 1                  # + the park segment
    count = torch.zeros(num, dtype=torch.int32, device=dev).index_add_(
        0, ix, torch.ones_like(ids, dtype=torch.int32))
    total = torch.zeros(num, dtype=torch.float32, device=dev).index_add_(
        0, ix, values)
    vmin = torch.full((num,), float("inf"), device=dev).scatter_reduce(
        0, ix, values, "amin", include_self=True)
    vmax = torch.full((num,), float("-inf"), device=dev).scatter_reduce(
        0, ix, values, "amax", include_self=True)
    return (count[:n_segments], total[:n_segments], vmin[:n_segments],
            vmax[:n_segments])


def np_segment_reduce(ids, values, n_segments: int):
    """Host numpy ``bincount`` ground truth for segment reduction — the
    semantics every backend must reproduce.  Rows with ids outside
    [0, n_segments) are ignored; sums accumulate in float64 and round
    once to f32 at the end, so any f32 reduction order that is exact
    (integer-valued data, counts) is bit-identical to it.
    """
    ids = np.asarray(ids)
    if values is None:
        values = np.zeros(ids.shape, np.float32)
    values = np.asarray(values)
    valid = (ids >= 0) & (ids < n_segments)
    ids = ids[valid].astype(np.int64)
    vals = values[valid].astype(np.float64)
    count = np.bincount(ids, minlength=n_segments).astype(np.int32)
    total = np.bincount(ids, weights=vals,
                        minlength=n_segments).astype(np.float32)
    vmin = np.full(n_segments, np.inf, np.float64)
    np.minimum.at(vmin, ids, vals)
    vmax = np.full(n_segments, -np.inf, np.float64)
    np.maximum.at(vmax, ids, vals)
    return count, total, vmin.astype(np.float32), vmax.astype(np.float32)


def flash_attn_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, bk: int, spread: bool = False,
                    scale: Optional[float] = None):
    """Twin of the flash kernel (src/repro/kernels/flash_attn.py
    ``_flash_kernel``): q, k, v [BH, S, D] -> [BH, S, D] in q's dtype.

    It walks the Pallas kernel's sequential KV axis in tiles of ``bk``
    keys, with its arithmetic: s = q . k^T in f32 times ``scale`` (default
    1 / sqrt(D); a caller that zero-pads D passes the true D's); keys
    past S (the ragged last tile, here cut short) and, when causal,
    kpos > qpos masked to -1e30; m and l in f32, l summing the f32 p; acc
    += p.astype(v.dtype) @ v in f32; out = acc / max(l, 1e-30).  The
    query tiles need no loop: rows are independent, so the Pallas ``bq``
    changes no bit.  Note ``models.attention.blockwise_attn`` differs: it
    sums p into l after rounding it to bf16.

    With ``spread=True`` it returns ``(out, spread)``: spread [BH, S, D]
    f32 is sum_j p_j |v_j| / l over the same p and l, what bounds the
    output's move when some p round to the neighbouring value of v's
    dtype (at most 2^-7 p_j each in bf16).
    """
    bh, s, d = q.shape
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    qf = q.float()
    qpos = torch.arange(s, device=q.device)[:, None]
    m = torch.full((bh, s, 1), -1.0e30, dtype=torch.float32, device=q.device)
    l = torch.zeros((bh, s, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((bh, s, d), dtype=torch.float32, device=q.device)
    acc_abs = torch.zeros_like(acc) if spread else None
    for k0 in range(0, s, bk):
        kt, vt = k[:, k0:k0 + bk], v[:, k0:k0 + bk]
        sc = (qf @ kt.float().transpose(1, 2)) * scale
        if causal:
            kpos = k0 + torch.arange(kt.shape[1], device=q.device)
            sc = torch.where(kpos[None, :] <= qpos, sc, -1.0e30)
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        p = torch.exp(sc - m_new)
        r = torch.exp(m - m_new)
        l = l * r + p.sum(dim=-1, keepdim=True)
        acc = acc * r + p.to(v.dtype).float() @ vt.float()
        if spread:
            acc_abs = acc_abs * r + p @ vt.float().abs()
        m = m_new
    l = torch.clamp_min(l, 1e-30)
    out = (acc / l).to(q.dtype)
    return (out, acc_abs / l) if spread else out

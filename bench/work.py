"""The least time a kernel launch could take on an H100: its bytes and
operations, counted from the launch's own inputs, over the published peaks.

Frozen from ``chip_smoke.py``'s work counts (a test holds them equal on
small CPU cases), so that a later change to the program cannot move the
yardstick.  Bytes: each input read once, each output written once; the
segment kernel's sorted ids only where searched; the candidate pool's live
edges only.  Operations: the crossing tests, box tests and segment rows
these inputs need, in fp32.
"""
from __future__ import annotations

import torch

# NVIDIA H100 SXM data sheet: HBM3 rate, fp32 (non-tensor) peak.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
OPS_PER_EDGE_TEST = 6         # 4 subtractions + 2 products
OPS_PER_BOX_TEST = 4          # 4 comparisons
OPS_PER_SEGMENT_ROW = 3       # add, min, max
SECTOR_BYTES = 32             # one DRAM sector: a binary-search step's read

# Kernels whose count reads their data (and so waits for the device);
# the others are counted from shapes alone.
READS_DATA = ("crossings_candidates", "crossings_one", "assign_cascade")


def call_bytes(args, outs) -> int:
    return sum(t.numel() * t.element_size() for t in list(args) + list(outs)
               if isinstance(t, torch.Tensor))


def cascade_edge_tests(fast_mod, index, pts, bid, flags, nskip) -> int:
    """Edge tests the cascade kernel ran on this batch: for each boundary
    point, the BE-edge blocks of every candidate slot it attempted
    (valid, no earlier hit) whose bbox held the point."""
    pool, bbox = index.edge_pool, index.block_bbox
    k = index.cand.shape[1]
    slots = torch.arange(k, device=pts.device)[None, :]
    tests = 0
    for lo in range(0, pts.shape[0], 1 << 22):
        sl = slice(lo, lo + (1 << 22))
        p, b, f = pts[sl], bid[sl], flags[sl]
        v = fast_mod.cell_values(index, p)
        boundary = (f & 1) == 1
        cand = index.cand[(-(v + 1)).clamp(0, index.cand.shape[0] - 1)]
        valid = boundary[:, None] & (cand >= 0)
        safe = cand.clamp(0, bbox.shape[0] - 1)
        bb = bbox[safe]
        px, py = p[:, 0:1], p[:, 1:2]
        inb = ((px > bb[..., 0]) & (px < bb[..., 1])
               & (py > bb[..., 2]) & (py < bb[..., 3]))
        hit = (cand == b[:, None]) & valid
        hit[:, 0] = (f & 2) == 2
        hit_slot = torch.where(hit.any(1), hit.int().argmax(1), k)
        attempted = valid & (slots <= hit_slot[:, None])
        if not torch.equal((attempted & ~inb).sum(1).int(), nskip[sl]):
            raise ValueError("cascade work count: rebuilt bbox rejections "
                             "!= nskip")
        tests += int((pool.count[safe] * (attempted & inb)).sum())
    return tests * pool.be


def segment_work(ids, values, n_segments) -> tuple:
    n = ids.shape[0]
    steps = max(1, (n - 1).bit_length())
    nbytes = 16 * n_segments + (n_segments + 1) * steps * SECTOR_BYTES
    if values is None:
        return nbytes, n_segments
    return nbytes + 4 * n, n * OPS_PER_SEGMENT_ROW


def candidates_work(pids, points, first, count, live, blocks,
                    max_blocks=1) -> tuple:
    valid = pids >= 0
    safe = pids.clamp(0, first.shape[0] - 1).long()
    n = torch.minimum(live[safe].long(), count[safe].long() * blocks.shape[2])
    tests = int(torch.where(valid, n, 0).sum())
    nbytes = (16 * pids.shape[0] + 12 * first.shape[0]
              + 16 * int(live.long().sum()))
    return nbytes, tests


def live_edges(edges) -> int:
    """Rows of an [E, 4] table that ``crossings_one`` stages: y1 != y2."""
    return int((edges[:, 1] != edges[:, 3]).sum())


def launch_work(name, args, kw, outs, index=None, fast_mod=None):
    """(bytes, operations) of one launch of kernel entry ``name``, or None
    for a kernel this table does not count."""
    if name == "segment_reduce_sorted":
        return segment_work(*args)
    if name == "crossings_candidates":
        b, tests = candidates_work(*args, **kw)
        return b, tests * OPS_PER_EDGE_TEST
    nbytes = call_bytes(args, outs)
    if name == "crossings_gathered":
        return nbytes, args[1].shape[0] * args[1].shape[1] * OPS_PER_EDGE_TEST
    if name == "crossings_one":
        return nbytes, (args[0].shape[0] * live_edges(args[1])
                        * OPS_PER_EDGE_TEST)
    if name == "bbox_mask":
        return nbytes, args[0].shape[0] * args[1].shape[0] * OPS_PER_BOX_TEST
    if name == "bbox_count_select":
        return nbytes, args[1].shape[0] * args[1].shape[1] * OPS_PER_BOX_TEST
    if name == "assign_cascade":
        bid, flags, _, nskip = outs
        return nbytes, cascade_edge_tests(fast_mod, index, args[0], bid,
                                          flags, nskip) * OPS_PER_EDGE_TEST
    return None


def least_seconds(nbytes: float, ops: float) -> float:
    """max(bytes / HBM rate, operations / fp32 peak)."""
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)


def bound_ms(name, calls, index, fast_mod) -> tuple:
    """Least time for the work of ``calls`` ((args, kwargs, outputs) of
    one kernel), as ``chip_smoke.bound_ms`` gives it: (ms, what bounds it,
    bytes, operations)."""
    nbytes = ops = 0
    for args, kw, outs in calls:
        b, o = launch_work(name, args, kw, outs, index, fast_mod)
        nbytes, ops = nbytes + b, ops + o
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, ops)

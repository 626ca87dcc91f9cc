#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (src/repro_torch) on one GPU.

    python3 chip_smoke.py [--out results.json]

Drives the port's mapping, analytics, serving and LM serving paths
through their public entry points (``GeoEngine.build`` / ``assign`` /
``assign_padded``, ``ops.pip_one``, ``BlockAggregator``,
``ops.assign_aggregate``, ``GeoServer``, ``repro_torch.launch.serve``) on
the card:

  1. prints the card (nvidia-smi name and power limit), torch and nvcc
     versions, and builds the CUDA kernels from ``src/repro_torch/
     kernels/csrc`` (build seconds, ptxas register counts), and beside
     them a copy of the flash kernel with a planted fault (one KV tile
     skipped); meanwhile a child process builds the host map of phase 3;
  2. LM path: ``flash_attn_bhsd`` against its twin (f32 and bf16, causal
     and full, D 16 / 64 / 128, S 64 / 100 / 300 / 2048, a second launch
     bit-equal; GQA through ``flash_attn`` and ``ops.flash_attn``), then
     Qwen1.5-0.5B at full width (24 layers, d 1024, vocab 151,936; random
     weights from ``LM_SEED``) serving 8 prompts of 2,048 tokens and 64
     greedy tokens through ``launch.serve.serve``: the prefill launches
     the flash kernel once per layer (each call held against the twin,
     and the planted fault shown to fail the same bound on each), decode
     launches none of the eight kernels, and a teacher-forced
     ``forward`` over prompt + generated tokens agrees with decode's
     logits and, wherever its top-2 margin is clear, with its tokens;
  3. the benchmark-scale census (benchmarks/common.py SCALE: 16 states /
     128 counties / 3,072 blocks) and its covering at max_level 9, from
     the child process, and six engines on cuda: ``fast`` (gathered PIP
     kernel), ``fast`` with ``fused=True`` (candidate PIP kernel),
     ``fast_onepass`` (one-pass cascade kernel), ``simple`` and
     ``simple`` with ``fused=True`` (the bbox kernels, then gathered /
     candidate PIP per level) and ``hybrid`` (the cell lookup, then the
     simple cascade on boundary points);
  4. kernel phase: a 2^16-point batch through each engine, and through
     ``ops.pip_one`` against each state's edge table; every kernel call
     is held against its plain PyTorch twin on the same inputs (exact
     equality), and each engine against a CPU engine of the same config
     (the twins) on ids and stats; ``segment_reduce_sorted`` on 2^16 rows
     of uniform, skewed (40 % in one segment), invalid (parked and
     unparked), odd-``S`` and empty ids: integer-valued and absent (zero)
     columns exact against the twin and the numpy oracle, f32 columns
     within rtol 1e-5 of the oracle, and a second launch bit-equal to
     the first;
  5. main path: 2^24 points through each engine, with every launch
     counter set to 0 just before and read just after (the kernels each
     engine must launch, and no other); block ids equal across the exact
     paths and to ground truth (accuracy 1.0), ``hybrid`` equal to
     ``fast`` id for id, ``simple`` equal to ``simple`` fused in ids and
     stats, no overflow, ``assign_padded`` -1 on its pad rows; then the
     2^24 points against all 16 state tables through ``ops.pip_one``;
     then the analytics path: ``BlockAggregator.fused_counts`` of the
     2^24 points through ``fast`` (equal to ``np.bincount`` of the
     assigned ids; the segment kernel launched once), ``reduce`` with an
     integer-valued column (equal to the numpy oracle) and
     ``ops.assign_aggregate`` on the ``fast_onepass`` index (equal to the
     segment reduction of the cascade's ids);
  6. serving path: a ``GeoServer`` over ``fast`` with the windowed
     analytics mounted replays examples/analytics_geo.py's stream on
     this map (served ids equal direct assigns, cache on = cache off,
     analytics snapshot equal to a CPU port server's on the same
     requests, spans and histograms for every stage), then serves 256
     requests of 16,384 points (pts/s, p50/p99 request latency);
  7. times each engine (pts/s), ``fused_counts`` (pts/s, and its
     assign / sort / kernel split), the LM's prefill and decode tok/s,
     and each kernel at the main path's inputs beside its plain twin,
     its bound and, for flash attention, ``scaled_dot_product_attention``
     (timed only: the port never calls it).

Kernel calls are held against their twins as they happen when their
arguments are too large to keep (the simple path's gathered state edges
are 19 GB a call at 2^24 points); the calls that are timed are kept.
Any failed check raises and the script exits non-zero.  The last line
is the device JSON; the line before it the kernels JSON.  Without a
CUDA device it exits non-zero and prints no result.
"""
import argparse
import contextlib
import ctypes
import dataclasses
import itertools
import json
import math
import multiprocessing
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
# benchmarks/common.py SCALE: 16 states / 128 counties / 3,072 blocks.
SCALE = dict(seed=0, n_states=16, counties_per_state=8, blocks_per_county=24)
MAX_LEVEL = 9
N_MAIN = 1 << 24
N_KERNEL = 1 << 16
N_PADDED, PAD_TO = 1000, 4096
TWIN_CHUNK = 1 << 18          # rows per plain-twin call (bounds its memory)
TIMED_BATCHES = 3
KERNEL_REPS = 5
LEAD_CYCLES = 10_000_000      # ~5 ms of spin on the card before a timing
# NVIDIA H100 SXM data sheet: HBM3 rate, fp32 (non-tensor) peak, dense
# bf16 tensor-core peak.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
OPS_PER_EDGE_TEST = 6         # 4 subtractions + 2 products (crosses())
OPS_PER_BOX_TEST = 4          # 4 comparisons (in_box())
OPS_PER_SEGMENT_ROW = 3       # add, min, max (segment.cu add_value())
SECTOR_BYTES = 32             # one DRAM sector: a binary-search step's read
# f32 segment sums vs the f64 oracle: the card's fixed-order tree sums
# came within 1.44e-7 relative on the kernel phase's cases.
SUM_RTOL = 1e-5
# examples/analytics_geo.py's stream and analytics mount.
SERVE_BUCKETS = (1024, 4096, 16384)
SERVE_SECONDS, SERVE_BACKGROUND, SERVE_VENUE, SERVE_TAIL_T = 16, 2048, 1024, 32.0
LOAD_REQUESTS, LOAD_POINTS = 256, 16384
# The LM serving path: Qwen1.5-0.5B at full width, a chat-style batch.
LM_ARCH, LM_BATCH, LM_PROMPT, LM_GEN, LM_SEED = "qwen1.5-0.5b", 8, 2048, 64, 0
FLASH_DIMS, FLASH_LENGTHS = (16, 64, 128), (64, 100, 300, 2048)
# Flash kernel vs its twin.  f32: within 1e-5 absolute (summation order
# only; on an H100 the cases came within 1.4e-6).  bf16, element by
# element: two bf16 ulps of the twin's output plus 2^-7 times the twin's
# spread, sum_j p_j |v_j| / l (``ref.flash_attn_bhsd(spread=True)``).
# Kernel and twin round p to bf16 from scores summed in another order, so
# a p at a rounding edge can round to the neighbouring value, a step of
# at most 2^-7 p_j; those steps move the output by at most 2^-7 times the
# spread, and its own rounding by up to two ulps.  (On an H100 a 2-ulp
# bound alone failed a [2, 2048, 64] case at 2.5 ulps.)  The f32 cases
# run the same code without the roundings and hold its arithmetic to
# 1e-5.  The bound must also have teeth at the prefill's shape: a copy of
# the kernel that skips KV tile FAULT_TILE must fail it on every prefill
# call.
FLASH_F32_ATOL, FLASH_BF16_ULPS, FLASH_P_STEP = 1e-5, 2.0, 2.0 ** -7
FAULT_TILE = 48               # keys 1,536-1,567 of the prefill's 2,048
# Teacher-forced logits (f32, scale ~1): decode against forward over the
# same tokens, both in bf16 through 24 layers; on an H100 they came
# 0.068-0.071 apart (the CPU tests see 0.05 between repro and the port
# over two layers).
LOGIT_TOL = 0.125
SERVE_STAGES = ("queue_wait", "host_prepare", "device_assign", "merge",
                "request", "analytics_observe")
SPAN_NAMES = {"request", "submit", "queue_wait", "host_prepare", "route",
              "cache_lookup", "cache_learn", "device_assign", "merge"}
KERNELS = {
    "assign_cascade": ("src/repro_torch/kernels/csrc/cascade.cu",
                       "src/repro/kernels/cascade.py:224"),
    "crossings_candidates": ("src/repro_torch/kernels/csrc/gather_pip.cu",
                             "src/repro/kernels/gather_pip.py:151"),
    "crossings_gathered": ("src/repro_torch/kernels/csrc/pip.cu",
                           "src/repro/kernels/pip.py:113"),
    "crossings_one": ("src/repro_torch/kernels/csrc/pip.cu",
                      "src/repro/kernels/pip.py:86"),
    "bbox_mask": ("src/repro_torch/kernels/csrc/bbox.cu",
                  "src/repro/kernels/bbox.py:57"),
    "bbox_count_select": ("src/repro_torch/kernels/csrc/bbox.cu",
                          "src/repro/kernels/bbox.py:80"),
    "segment_reduce_sorted": ("src/repro_torch/kernels/csrc/segment.cu",
                              "src/repro/kernels/segment.py:83"),
    "flash_attn_bhsd": ("src/repro_torch/kernels/csrc/flash_attn.cu",
                        "src/repro/kernels/flash_attn.py:78"),
}
# The kernels each engine's assign must launch (and no other).
ENGINE_KERNELS = {
    "fast": ("crossings_gathered",),
    "fast_fused": ("crossings_candidates",),
    "fast_onepass": ("assign_cascade",),
    "simple": ("bbox_mask", "bbox_count_select", "crossings_gathered"),
    "simple_fused": ("bbox_mask", "bbox_count_select",
                     "crossings_candidates"),
    "hybrid": ("bbox_mask", "bbox_count_select", "crossings_gathered"),
    "fused_counts": ("crossings_gathered", "segment_reduce_sorted"),
    "serving": ("crossings_gathered",),
    "lm_prefill": ("flash_attn_bhsd",),
    "lm_decode": (),
    "lm_forward": ("flash_attn_bhsd",),
}
# The main-path run whose calls each kernel's row is measured on.
ROW_PATH = {"assign_cascade": "fast_onepass",
            "crossings_candidates": "fast_fused",
            "crossings_gathered": "fast", "bbox_mask": "simple",
            "bbox_count_select": "simple", "crossings_one": "pip_one",
            "segment_reduce_sorted": "fused_counts"}
# Positional arguments of each kernel wrapper that are per-row.
ROW_ARGS = {"assign_cascade": (0,), "crossings_candidates": (0, 1, 2),
            "crossings_gathered": (0, 1), "crossings_one": (0,),
            "bbox_mask": (0,), "bbox_count_select": (0, 1),
            "segment_reduce_sorted": (0, 1)}


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` runs (CUDA events,
    after one warm run).  A spin kernel ahead of the start event keeps
    the card busy while the host queues the runs, so a kernel shorter
    than its launch's host overhead is timed on the device, not at the
    host's launch rate."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(LEAD_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def flash_over(out, want, spread) -> float:
    """Max over the elements of |out - want| / (FLASH_BF16_ULPS bf16 ulps
    of want + FLASH_P_STEP spread); equal elements count 0."""
    if not out.numel():
        return 0.0
    want = want.float()
    diff = (out.float() - want).abs()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs())) - 7)   # 0 at 0
    tol = FLASH_BF16_ULPS * ulp + FLASH_P_STEP * spread
    return float(torch.where(diff == 0, 0.0, diff / tol).max())


def flash_err(out, want, spread, what) -> tuple:
    """(max abs err, max err / tolerance) of a flash output against its
    twin's ``(want, spread)``; raises unless it is within the dtype's
    tolerance (see FLASH_*)."""
    err = max_abs_err(out, want, what)
    if out.dtype == torch.float32:
        check(err <= FLASH_F32_ATOL, f"{what}: max abs err {err} > "
                                     f"{FLASH_F32_ATOL}")
        return err, err / FLASH_F32_ATOL
    over = flash_over(out, want, spread)
    check(over <= 1.0, f"{what}: max abs err {err}, {over:.3g}x the "
                       f"tolerance")
    return err, over


def max_abs_err(a, b, what):
    """Max |a - b| of two same-shape, same-type tensors; equal values
    (infinities included) count 0."""
    check(a.shape == b.shape and a.dtype == b.dtype,
          f"{what}: output {a.shape}/{a.dtype} vs {b.shape}/{b.dtype}")
    if not a.numel():
        return 0
    if a.is_floating_point():
        d = torch.where(a == b, 0.0, (a.double() - b.double()).abs())
        return float(torch.nan_to_num(d, nan=float("inf")).max())
    return int((a.long() - b.long()).abs().max())


def call_bytes(args, outs) -> int:
    return sum(t.numel() * t.element_size() for t in list(args) + list(outs)
               if isinstance(t, torch.Tensor))


@dataclasses.dataclass
class Capture:
    """What ``Smoke.capture`` saw: ``calls[name]`` the kept calls (args,
    kwargs, outputs); ``checked[name]`` the calls held against the twin
    as they happened (count, rows, bytes, max abs err)."""

    calls: dict
    checked: dict


class Smoke:
    def __init__(self):
        from repro_torch.kernels import (_build, bbox, cascade, flash_attn,
                                         gather_pip, pip, ref, segment)
        self.build, self.ref, self.flash = _build, ref, flash_attn
        self.modules = {"assign_cascade": cascade,
                        "crossings_candidates": gather_pip,
                        "crossings_gathered": pip, "crossings_one": pip,
                        "bbox_mask": bbox, "bbox_count_select": bbox,
                        "segment_reduce_sorted": segment,
                        "flash_attn_bhsd": flash_attn}

    @contextlib.contextmanager
    def capture(self, keep=None):
        """Record every kernel-wrapper call made through ``ops`` inside the
        block; the calls still launch.  Calls of the kernels in ``keep``
        (default: all) are kept whole; every other call is held against
        its twin at once, and only its summary is kept."""
        keep = set(self.modules) if keep is None else set(keep)
        cap = Capture({name: [] for name in self.modules},
                      {name: dict(calls=0, rows=0, bytes=0, max_abs_err=0)
                       for name in self.modules})
        saved = {name: getattr(m, name) for name, m in self.modules.items()}

        def recorder(name, fn):
            def rec(*args, **kw):
                out = fn(*args, **kw)
                call = (args, kw, out if isinstance(out, tuple) else (out,))
                if name in keep:
                    cap.calls[name].append(call)
                else:
                    c = cap.checked[name]
                    c["calls"] += 1
                    c["rows"] += args[0].shape[0]
                    c["bytes"] += call_bytes(args, call[2])
                    c["max_abs_err"] = max(c["max_abs_err"],
                                           self.compare(name, [call]))
                return out
            return rec

        for name, m in self.modules.items():
            setattr(m, name, recorder(name, saved[name]))
        try:
            yield cap
        finally:
            for name, m in self.modules.items():
                setattr(m, name, saved[name])

    def twin(self, name, args, kw):
        """The kernel's plain twin on one call's inputs, run over
        TWIN_CHUNK-row slices (the twins materialize [rows, ...] temps)."""
        ref = self.ref
        if name == "segment_reduce_sorted":    # a reduction over all rows
            return ref.segment_reduce(*args)
        if name == "flash_attn_bhsd":          # (out, spread): see FLASH_*
            return ref.flash_attn_bhsd(*args, **kw, bk=self.flash.KV_TILE,
                                       spread=True)
        rows = args[0].shape[0]
        parts = []
        for lo in range(0, rows, TWIN_CHUNK):
            a = [x[lo:lo + TWIN_CHUNK] if i in ROW_ARGS[name] else x
                 for i, x in enumerate(args)]
            if name == "crossings_candidates":
                first, nblk, points, blocks = a
                out = (ref.crossings_candidates(points, first, nblk, blocks,
                                                kw["max_blocks"]),)
            elif name == "assign_cascade":
                count = a[9]
                out = ref.assign_cascade(
                    *a, **kw, max_blocks=max(int(count.max()), 1))
            else:
                out = getattr(ref, name)(*a)
                out = out if isinstance(out, tuple) else (out,)
            parts.append(out)
        return tuple(torch.cat(p) for p in zip(*parts))

    def compare(self, name, calls):
        """Max |kernel - twin| over every output of every call (float
        outputs: equal values, infinities included, count 0; NaN against
        a number counts inf).  Flash attention is held to its tolerance
        here (``flash_err``); every other kernel must give 0."""
        err = 0
        for args, kw, outs in calls:
            want = self.twin(name, args, kw)
            if name == "flash_attn_bhsd":
                err = max(err, flash_err(outs[0], *want, name)[0])
            else:
                err = max([err] + [max_abs_err(a, b, name)
                                   for a, b in zip(outs, want)])
        return err

    def check_all(self, cap, what: str) -> dict:
        """Hold every call of ``cap`` against its twin; return the number
        of calls per kernel."""
        n = {}
        for name in self.modules:
            kept = cap.calls[name]
            err = max(self.compare(name, kept),
                      cap.checked[name]["max_abs_err"])
            check(err == 0 or name == "flash_attn_bhsd",
                  f"{name} differs from its twin (max abs err {err}) on "
                  f"{what}")
            n[name] = len(kept) + cap.checked[name]["calls"]
        return n


def cascade_edge_tests(fast_mod, index, pts, bid, flags, nskip) -> int:
    """Edge tests the cascade kernel ran on this batch: for each boundary
    point, the BE-edge blocks of every candidate slot it attempted
    (valid, no earlier hit) whose bbox held the point.  The hit slot is
    read back from the kernel's outputs (slot 0 from flags bit 1, a later
    slot from bid; candidate ids in a row are unique), and the rebuilt
    bbox rejections must equal the kernel's nskip."""
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
        check(torch.equal((attempted & ~inb).sum(1).int(), nskip[sl]),
              "cascade work count: rebuilt bbox rejections != nskip")
        tests += int((pool.count[safe] * (attempted & inb)).sum())
    return tests * pool.be


def segment_work(ids, values, n_segments) -> tuple:
    """(bytes, operations) that ``segment_reduce_sorted`` needs: the
    values read once (none for a zero column), 16 bytes out per segment,
    and, since the ids are sorted, only the sectors of the S + 1 binary
    searches over them (one per step); 3 operations a row with values,
    one subtraction a segment without."""
    n = ids.shape[0]
    steps = max(1, (n - 1).bit_length())
    nbytes = 16 * n_segments + (n_segments + 1) * steps * SECTOR_BYTES
    if values is None:
        return nbytes, n_segments
    return nbytes + 4 * n, n * OPS_PER_SEGMENT_ROW


def bound_ms(name, calls, index, fast_mod) -> tuple:
    """Least time for the work of ``calls`` on an H100: the larger of the
    bytes moved (each input read once, each output written once; the
    segment kernel's sorted ids only where searched) over the HBM rate
    and the operations (crossing tests, box tests, segment rows) over
    the fp32 peak."""
    nbytes = ops = 0
    for args, kw, outs in calls:
        if name == "segment_reduce_sorted":
            b, o = segment_work(*args)
            nbytes, ops = nbytes + b, ops + o
            continue
        nbytes += call_bytes(args, outs)
        if name == "crossings_gathered":
            ops += args[1].shape[0] * args[1].shape[1] * OPS_PER_EDGE_TEST
        elif name == "crossings_one":
            ops += args[0].shape[0] * args[1].shape[0] * OPS_PER_EDGE_TEST
        elif name == "crossings_candidates":
            ops += (int(args[1].sum()) * args[3].shape[2]
                    * OPS_PER_EDGE_TEST)
        elif name == "bbox_mask":
            ops += args[0].shape[0] * args[1].shape[0] * OPS_PER_BOX_TEST
        elif name == "bbox_count_select":
            ops += args[1].shape[0] * args[1].shape[1] * OPS_PER_BOX_TEST
        else:
            bid, flags, _, nskip = outs
            ops += cascade_edge_tests(fast_mod, index, args[0], bid, flags,
                                      nskip) * OPS_PER_EDGE_TEST
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, ops)


def segment_phase(n_blocks) -> list:
    """``segment_reduce_sorted`` against its twin and the numpy oracle on
    2^16 rows: uniform, skewed (40 % in one segment), invalid (ids < 0
    and >= S, parked at S as ``ops`` parks them, and unparked, straight
    to the wrapper), an odd segment count and an empty input, each with
    an integer-valued column, a uniform f32 column and no column (a zero
    column the kernel never reads).  Returns one summary row per case."""
    from repro_torch.kernels import ref, segment
    rng = np.random.default_rng(2)
    n = N_KERNEL
    uniform = rng.integers(0, n_blocks, n)
    skewed = uniform.copy()
    skewed[rng.random(n) < 0.4] = n_blocks // 3
    invalid = rng.integers(-3, n_blocks + 3, n)
    cases = [("uniform", uniform, n_blocks, True),
             ("skewed", skewed, n_blocks, True),
             ("invalid", invalid, n_blocks, True),
             ("unparked", invalid, n_blocks, False),
             ("odd_segments", rng.integers(0, 1000, n), 1000, True),
             ("empty", np.zeros(0, np.int64), n_blocks, True)]
    rows = []
    for name, ids, n_seg, parked in cases:
        ids = ids.astype(np.int32)
        for kind in ("int", "float", "none"):
            vals = None if kind == "none" else (
                rng.integers(-50, 50, len(ids)) if kind == "int"
                else rng.random(len(ids))).astype(np.float32)
            t_ids = torch.from_numpy(ids).cuda()
            if parked:
                t_ids = torch.where((t_ids < 0) | (t_ids >= n_seg), n_seg,
                                    t_ids)
            s_ids, order = torch.sort(t_ids, stable=True)
            s_vals = None if vals is None \
                else torch.from_numpy(vals).cuda()[order]
            first = segment.segment_reduce_sorted(s_ids, s_vals, n_seg)
            second = segment.segment_reduce_sorted(s_ids, s_vals, n_seg)
            twin = ref.segment_reduce(s_ids, s_vals, n_seg)
            torch.cuda.synchronize()
            oracle = ref.np_segment_reduce(ids, vals, n_seg)
            what = f"segment_reduce_sorted, {name} ids, {kind} values"
            check(all(torch.equal(a, b) for a, b in zip(first, second)),
                  f"{what}: a second launch is not bit-equal")
            err = 0
            for out, got, tw, want in zip(("count", "sum", "min", "max"),
                                          first, twin, oracle):
                host = got.cpu().numpy()
                if out == "sum" and kind == "float":
                    check(np.allclose(host, want, rtol=SUM_RTOL, atol=0),
                          f"{what}: sum beyond rtol {SUM_RTOL}")
                    continue
                e = max_abs_err(got, tw, what)
                check(e == 0 and np.array_equal(host, want),
                      f"{what}: {out} differs from the twin / oracle "
                      f"(max abs err {e})")
                err = max(err, e)
            total = np.abs(oracle[1]).astype(np.float64)
            rel = float(np.max(np.abs(first[1].cpu().numpy() - oracle[1])
                               / np.maximum(total, 1e-30))) \
                if len(ids) and kind == "float" else 0.0
            rows.append(dict(case=name, values=kind, rows=len(ids),
                             segments=n_seg, max_abs_err=err,
                             sum_max_rel_err=rel))
    return rows


def flash_phase(smoke) -> list:
    """``flash_attn_bhsd`` against its twin on the card: f32 and bf16,
    causal and full, D in FLASH_DIMS, S in FLASH_LENGTHS (100 and 300 are
    no tile multiple), BH 3 (2 at S = 2048), each within its tolerance
    and a second launch bit-equal to the first; then GQA 8:2 through
    ``flash_attn`` (S = 256, a tile multiple) and ``ops.flash_attn``
    (S = 100).  Returns one summary row per case."""
    from repro_torch.kernels import ops
    fa, ref = smoke.flash, smoke.ref
    gen = torch.Generator(device="cuda").manual_seed(3)

    def rand(*shape, dtype):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    rows = []
    for dtype, causal, d, s in itertools.product(
            (torch.float32, torch.bfloat16), (True, False), FLASH_DIMS,
            FLASH_LENGTHS):
        bh = 2 if s >= 2048 else 3
        q, k, v = (rand(bh, s, d, dtype=dtype) for _ in range(3))
        out = fa.flash_attn_bhsd(q, k, v, causal=causal)
        again = fa.flash_attn_bhsd(q, k, v, causal=causal)
        twin = smoke.twin("flash_attn_bhsd", (q, k, v), {"causal": causal})
        torch.cuda.synchronize()
        what = f"flash_attn_bhsd {dtype} causal={causal} [{bh}, {s}, {d}]"
        check(torch.equal(out, again), f"{what}: a second launch is not "
                                       f"bit-equal")
        err, over = flash_err(out, *twin, what)
        rows.append(dict(case="bhsd", dtype=str(dtype).split(".")[-1],
                         causal=causal, bh=bh, s=s, d=d, max_abs_err=err,
                         over=over))

    def twin_part(i):          # the twin's output (0) or spread (1)
        return lambda q, k, v, causal: ref.flash_attn_bhsd(
            q, k, v, causal=causal, bk=fa.KV_TILE, spread=True)[i]

    b, h, kh, d = 2, 8, 2, 64
    for s, fn, name in ((256, fa.flash_attn, "flash_attn"),
                        (100, ops.flash_attn, "ops.flash_attn")):
        q = rand(b, s, h, d, dtype=torch.bfloat16)
        k, v = (rand(b, s, kh, d, dtype=torch.bfloat16) for _ in range(2))
        out = fn(q, k, v, causal=True)
        want, spread = (fa.attend_bshd(twin_part(i), q, k, v, causal=True)
                        for i in (0, 1))
        torch.cuda.synchronize()
        err, over = flash_err(out, want, spread, f"GQA via {name}")
        rows.append(dict(case=f"gqa {h}:{kh} via {name}", dtype="bfloat16",
                         causal=True, bh=b * h, s=s, d=d, max_abs_err=err,
                         over=over))
    return rows


def start_fault_build(build, tmp):
    """Start nvcc on a copy of ``csrc/flash_attn.cu`` in ``tmp`` with one
    fault planted: every block skips KV tile FAULT_TILE.  Returns (the
    nvcc process, the library it writes)."""
    src = (build.CSRC / "flash_attn.cu").read_text()
    loop = "  for (int t = 0; t < tiles; ++t) {\n"
    check(src.count(loop) == 1, "flash_attn.cu: the KV tile loop is not "
                                "where the planted fault goes")
    cu = os.path.join(tmp, "flash_attn_fault.cu")
    with open(cu, "w") as f:
        f.write(src.replace(
            loop, loop + f"    if (t == {FAULT_TILE}) continue;\n"))
    lib = os.path.join(tmp, "libflash_fault.so")
    return subprocess.Popen(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-shared", "-o", lib, cu],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib


def load_fault(build, proc, lib_path):
    """Wait for ``start_fault_build``'s nvcc and bind its library: a
    function of bf16 q, k, v [BH, S, D] -> the faulty causal output.  Its
    launches are counted nowhere."""
    log = proc.communicate()[0]
    check(proc.returncode == 0, f"planted-fault flash build failed:\n{log}")
    fn = ctypes.CDLL(lib_path).repro_flash_attn_bhsd
    fn.argtypes = build._SIGNATURES["repro_flash_attn_bhsd"]
    fn.restype = ctypes.c_int

    def faulty(q, k, v):
        out = torch.empty_like(q)
        bh, s, d = q.shape
        status = fn(build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(out),
                    bh, s, d, 1, 1, ctypes.c_float(1.0 / math.sqrt(d)),
                    build.stream_of(q))
        check(status == 0, f"planted-fault flash launch failed ({status})")
        return out
    return faulty


def flash_bound(q, causal: bool) -> tuple:
    """(bound ms, by, bytes, operations) of one flash call on an H100: q,
    k, v read once and o written once, over the HBM rate; 4 BH S^2 D
    operations (2 products of [S, D] by [D, S]), half under the causal
    mask, over the tensor-core peak of the input dtype (bf16) or the
    fp32 peak."""
    bh, s, d = q.shape
    nbytes = 4 * q.numel() * q.element_size()
    ops = 4 * bh * s * s * d // (2 if causal else 1)
    peak = BF16_OPS_PER_S if q.dtype == torch.bfloat16 else FP32_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, ops)


def pip_one_states(ops, state_edges, pts):
    """[S, N] inside masks of every point against each state's edge
    table, through the public ``ops.pip_one``."""
    return torch.stack([ops.pip_one(pts, state_edges[s])
                        for s in range(state_edges.shape[0])])


def lm_path(smoke, result, launches, main_calls, faulty):
    """The LM serving path on the card (phase 2 of the module doc): the
    flash kernel phase, then Qwen1.5-0.5B at full width through
    ``launch.serve.serve`` with the launch counts of each phase, every
    prefill flash call held against the twin (and ``faulty``, the kernel
    with a planted fault, shown to fail the same bound on each), and the
    teacher-forced check.  Records the prefill's flash launches and its
    first call (for the timing) in ``launches`` / ``main_calls``; returns
    (model, prompts, generated tokens)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_mod
    result["flash_phase"] = flash_phase(smoke)
    f32_err = max(r["max_abs_err"] for r in result["flash_phase"]
                  if r["dtype"] == "float32")
    bf16_worst = max(r["over"] for r in result["flash_phase"]
                     if r["dtype"] == "bfloat16")
    print(f"kernel phase: flash_attn_bhsd == twin on "
          f"{len(result['flash_phase'])} cases (f32 and bf16, causal and "
          f"full, D {FLASH_DIMS}, S {FLASH_LENGTHS}; GQA 8:2 via "
          f"flash_attn and ops.flash_attn): f32 max abs err {f32_err:.3g} "
          f"(tol {FLASH_F32_ATOL}), bf16 within {bf16_worst:.3g}x the "
          f"tolerance ({FLASH_BF16_ULPS} ulps + {FLASH_P_STEP} spread, "
          f"element by element); second launch bit-equal")
    lm_cfg = get_config(LM_ARCH)
    n_layers = lm_cfg.n_layers
    t0 = time.perf_counter()
    model = serve_mod.load_model(lm_cfg, seed=LM_SEED, device="cuda")
    prompts = serve_mod.make_prompts(lm_cfg, LM_BATCH, LM_PROMPT, LM_SEED,
                                     "cuda")
    torch.cuda.synchronize()
    result["lm_load_s"] = time.perf_counter() - t0
    result["lm_params"] = model.param_count()
    print(f"LM: {lm_cfg.name} at full width ({n_layers} layers, d "
          f"{lm_cfg.d_model}, {lm_cfg.n_heads} heads of {lm_cfg.hd}, d_ff "
          f"{lm_cfg.d_ff}, vocab {lm_cfg.vocab}): {result['lm_params']} "
          f"parameters, random from seed {LM_SEED}, on the card in "
          f"{result['lm_load_s']:.2f} s")
    phase_counts = {}

    def on_phase(name, edge):
        if edge == "start":
            smoke.build.reset_launches()
        else:
            phase_counts[name] = dict(smoke.build.LAUNCHES)

    with smoke.capture(keep=["flash_attn_bhsd"]) as cap:
        res = serve_mod.serve(model, prompts, LM_GEN, on_phase=on_phase)
    for name, counts in phase_counts.items():
        for kname, n in counts.items():
            want = kname in ENGINE_KERNELS[f"lm_{name}"]
            check((n > 0) == want, f"LM {name}: {kname} launched {n} times")
    check(phase_counts["prefill"]["flash_attn_bhsd"] == n_layers,
          f"LM prefill: flash_attn_bhsd launched "
          f"{phase_counts['prefill']['flash_attn_bhsd']} times, not once "
          f"per layer ({n_layers})")
    prefill_calls = cap.calls["flash_attn_bhsd"]
    bhsd = (LM_BATCH * lm_cfg.n_heads, LM_PROMPT, lm_cfg.hd)
    check(len(prefill_calls) == n_layers and all(
        a[0].shape == bhsd and a[0].dtype == torch.bfloat16
        and kw == {"causal": True} for a, kw, _ in prefill_calls),
        f"LM prefill: flash calls not {n_layers} causal bf16 {bhsd}")
    lm_err, lm_over, fault_over, fault_vmax = 0.0, 0.0, [], []
    for args, kw, (out,) in prefill_calls:
        want, spread = smoke.twin("flash_attn_bhsd", args, kw)
        err, over = flash_err(out, want, spread, "LM prefill flash call")
        lm_err, lm_over = max(lm_err, err), max(lm_over, over)
        # The planted fault must fail where the kernel passes.
        bad = faulty(*args)
        fault_over.append(flash_over(bad, want, spread))
        # What the earlier whole-call rule (2^-7 max|v|) would have said.
        fault_vmax.append(float((bad.float() - want.float()).abs().max()
                                / (FLASH_P_STEP
                                   * args[2].float().abs().max())))
        del want, spread, bad
    check(min(fault_over) > 1.0,
          f"LM prefill: a kernel that skips KV tile {FAULT_TILE} passes the "
          f"flash tolerance on a call ({min(fault_over):.3g}x)")
    launches["flash_attn_bhsd"] = phase_counts["prefill"]["flash_attn_bhsd"]
    main_calls["flash_attn_bhsd"] = prefill_calls[:1]
    del cap, prefill_calls
    gen_tok = res.tokens
    check(gen_tok.shape == (LM_BATCH, LM_GEN)
          and bool(((gen_tok >= 0) & (gen_tok < lm_cfg.vocab)).all())
          and torch.equal(gen_tok[:, 0], res.prefill_logits.argmax(-1).int())
          and bool(torch.isfinite(res.prefill_logits).all()),
          "LM: generated tokens out of range or not the prefill's argmax")
    print(f"main path LM prefill: {LM_BATCH} x {LM_PROMPT} tokens, launches "
          f"{ {k: v for k, v in phase_counts['prefill'].items() if v} } (one "
          f"per layer over B * H = {bhsd[0]} heads); each call == twin "
          f"(max abs err {lm_err:.3g}, {lm_over:.3g}x the tolerance; the "
          f"kernel with KV tile {FAULT_TILE} skipped fails it on every call, "
          f"{min(fault_over):.3g}-{max(fault_over):.3g}x; against the earlier "
          f"2^-7 max|v| rule {min(fault_vmax):.3g}-{max(fault_vmax):.3g}x); "
          f"decode "
          f"{LM_GEN - 1} steps, launches "
          f"{ {k: v for k, v in phase_counts['decode'].items() if v} } (none "
          f"of the eight kernels)")
    # Teacher-forced: forward over prompt + generated tokens (its flash
    # calls held against the twin as they run), and decode fed the same
    # tokens; position S - 1 + i predicts generated token i.
    full = torch.cat([prompts, gen_tok], dim=1)
    run = serve_mod.run_config(LM_PROMPT)
    with smoke.capture(keep=[]) as cap:
        smoke.build.reset_launches()
        logits, _ = model.forward(run, {"tokens": full})
        torch.cuda.synchronize()
        counts = dict(smoke.build.LAUNCHES)
    for kname, n in counts.items():
        want = kname in ENGINE_KERNELS["lm_forward"]
        check((n > 0) == want, f"LM forward: {kname} launched {n} times")
    check(counts["flash_attn_bhsd"] == n_layers
          and cap.checked["flash_attn_bhsd"]["calls"] == n_layers,
          "LM forward: flash_attn_bhsd not once per layer")
    fwd_err = cap.checked["flash_attn_bhsd"]["max_abs_err"]
    pred = logits[:, LM_PROMPT - 1:LM_PROMPT - 1 + LM_GEN].clone()
    del logits
    with torch.inference_mode():
        lg, cache = model.prefill(run, prompts, LM_PROMPT + LM_GEN)
        dec = [lg[:, -1]]
        for i in range(LM_GEN - 1):
            lg, cache = model.decode_step(run, gen_tok[:, i:i + 1], cache)
            dec.append(lg[:, -1])
    dec = torch.stack(dec, dim=1)
    del cache
    dec_diff = float((dec - pred).abs().max())
    check(bool(torch.isfinite(pred).all()) and dec_diff <= LOGIT_TOL,
          f"LM: decode logits differ from forward's by {dec_diff} > "
          f"{LOGIT_TOL}")
    top = pred.topk(2, dim=-1)
    clear = (top.values[..., 0] - top.values[..., 1]) > LOGIT_TOL
    agree = top.indices[..., 0] == gen_tok.long()
    check(bool(agree[clear].all()), "LM: forward's argmax differs from a "
                                    "generated token where its margin is "
                                    "clear")
    result["lm_check"] = dict(
        prefill_flash_max_abs_err=lm_err, prefill_flash_over=lm_over,
        fault_over=fault_over, fault_over_vmax_rule=fault_vmax,
        forward_flash_max_abs_err=fwd_err, decode_vs_forward=dec_diff,
        skipped=int((~clear).sum()), agree_all=int(agree.sum()),
        distinct_tokens=int(torch.unique(gen_tok).numel()))
    print(f"main path LM teacher-forced: forward over {LM_BATCH} x "
          f"{full.shape[1]} tokens (flash once per layer, each == twin as it "
          f"ran, max abs err {fwd_err:.3g}); decode logits within "
          f"{dec_diff:.4g} of forward's (tol {LOGIT_TOL}); forward's argmax "
          f"== the generated token on all {int(clear.sum())} steps whose "
          f"top-2 margin > {LOGIT_TOL}, {result['lm_check']['skipped']} of "
          f"{clear.numel()} skipped ({int(agree.sum())} agree in all); "
          f"{result['lm_check']['distinct_tokens']} distinct tokens "
          f"generated")
    del pred, dec

    return model, prompts, gen_tok


def device_us(evt) -> float:
    """A profiler event's own device microseconds (the attribute's name
    differs across torch versions)."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def profile_busy(fn) -> dict:
    """Run ``fn`` once under torch.profiler: host wall ms (synchronized),
    device ms summed over kernels, the busy share, launches and the top
    kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=device_us, reverse=True)
    busy = sum(device_us(e) for e in kernels) / 1e3
    return dict(wall_ms=wall, device_ms=busy, busy=busy / wall,
                launches=sum(e.count for e in kernels),
                top=[(e.key[:60], device_us(e) / 1e3, e.count)
                     for e in kernels[:5]])


def lm_timing(model, prompts, gen_tok, result, card) -> None:
    """Prefill and decode tok/s and peak device memory of one more
    ``serve`` run (no capture, no checks inside it); then one prefill and
    four decode steps under torch.profiler (device busy share, top
    kernels)."""
    from repro_torch.launch import serve as serve_mod
    from repro_torch.runtime.steps import make_serve_step
    res_t = serve_mod.serve(model, prompts, LM_GEN)
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    result["lm"] = dict(
        batch=LM_BATCH, prompt=LM_PROMPT, gen=LM_GEN,
        prefill_s=res_t.prefill_s, decode_s=res_t.decode_s,
        prefill_tok_s=res_t.prefill_tok_s(),
        decode_tok_s=res_t.decode_tok_s(), weight_bytes=weights,
        peak_bytes=weights + res_t.peak_bytes,
        same_tokens=bool(torch.equal(res_t.tokens, gen_tok)))
    lm = result["lm"]
    print(f"LM serving ({card}): prefill {LM_BATCH} x {LM_PROMPT} in "
          f"{lm['prefill_s'] * 1e3:.1f} ms = {lm['prefill_tok_s']:.5g} tok/s; "
          f"{LM_GEN - 1} decode steps in {lm['decode_s'] * 1e3:.1f} ms = "
          f"{lm['decode_tok_s']:.5g} tok/s "
          f"({lm['decode_s'] / (LM_GEN - 1) * 1e3:.2f} ms a step); peak "
          f"device memory {lm['peak_bytes'] / 2**30:.2f} GiB (the weights "
          f"{weights / 2**30:.2f} GiB + the run's own peak); tokens equal "
          f"to the first run: {lm['same_tokens']}")
    run = serve_mod.run_config(LM_PROMPT)
    state = {}

    def prefill():
        state["out"] = model.prefill(run, prompts, LM_PROMPT + LM_GEN)

    step = make_serve_step(model, run)

    def decode():
        tok, cache = gen_tok[:, :1], state["out"][1]
        for _ in range(4):
            tok, cache = step(tok, cache)

    lm["profile"] = {"prefill": profile_busy(prefill),
                     "decode_4_steps": profile_busy(decode)}
    for name, p in lm["profile"].items():
        print(f"LM {name} under torch.profiler: wall {p['wall_ms']:.2f} ms, "
              f"device {p['device_ms']:.2f} ms (busy {p['busy']:.1%}), "
              f"{p['launches']} launches; top kernels "
              + "; ".join(f"{k} {ms:.2f} ms x{n}" for k, ms, n in p["top"]))


def flash_row(smoke, calls, launches: int) -> dict:
    """The flash kernel's row, per call at the prefill's shape ([B * H,
    S, hd] bf16, causal: ``calls`` holds the prefill's first call),
    beside its twin and PyTorch's fused attention on the same tensors
    viewed [B, H, S, hd] (timed only; the port never calls it)."""
    (q, k, v), kw, (out,) = calls[0]
    err = smoke.compare("flash_attn_bhsd", calls)
    fa_fn = smoke.flash.flash_attn_bhsd
    ms = cuda_ms(lambda: fa_fn(q, k, v, **kw), KERNEL_REPS)
    plain = cuda_ms(lambda: smoke.ref.flash_attn_bhsd(
        q, k, v, **kw, bk=smoke.flash.KV_TILE), 2)     # without the spread
    bh, s, d = q.shape
    q4, k4, v4 = (x.view(LM_BATCH, bh // LM_BATCH, s, d) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_diff = float((sdpa(q4, k4, v4, is_causal=True).float().reshape(
        out.shape) - out.float()).abs().max())
    library = cuda_ms(lambda: sdpa(q4, k4, v4, is_causal=True), KERNEL_REPS)
    bound, bound_by, nbytes, n_ops = flash_bound(q, kw["causal"])
    print(f"flash_attn_bhsd: {ms:.4f} ms per call at {list(q.shape)} bf16 "
          f"causal (the lm_prefill path: {launches} calls, "
          f"{ms * launches:.2f} ms a prefill; {n_ops / ms / 1e9:.4g} "
          f"TFLOP/s) vs plain twin {plain:.3f} ms, "
          f"scaled_dot_product_attention {library:.4f} ms (output within "
          f"{lib_diff:.3g} of the kernel's; kernel / library "
          f"{ms / library:.3g}x); bound {bound:.4f} ms by {bound_by} "
          f"({nbytes} B, {n_ops} ops); {bound / ms:.2%} of bound")
    return {"name": "flash_attn_bhsd", "route": "cuda",
            "source": KERNELS["flash_attn_bhsd"][0],
            "replaces": KERNELS["flash_attn_bhsd"][1], "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": library}


def host_map():
    """The census and its covering at SCALE, on the host (numpy; no card).
    Returns (census, covering, census s, covering s)."""
    from repro_torch.core.cells import build_cell_covering
    from repro_torch.core.synth import build_synth_census
    t0 = time.perf_counter()
    sc = build_synth_census(**SCALE)
    t1 = time.perf_counter()
    cov = build_cell_covering(sc.census, max_level=MAX_LEVEL)
    return sc, cov, t1 - t0, time.perf_counter() - t1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the full results as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs only on "
              "the card", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    phase_s = {}
    sys.path.insert(0, os.path.join(REPO, "src"))
    from repro_torch.core import fast as fast_mod
    from repro_torch.core.engine import EngineConfig, GeoEngine
    from repro_torch.kernels import ops

    result = {}
    # -- 1. card, toolchain, kernel build ------------------------------------
    card = card_line()
    print(card)
    nvcc = subprocess.run([os.path.join(os.environ.get(
        "CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"), "--version"],
        capture_output=True, text=True).stdout.strip().splitlines()
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}); "
          f"{nvcc[-1] if nvcc else 'nvcc not found'}")
    # The host map (phase 3) needs no card: a child process builds it
    # while the card builds the kernels and runs the LM path.
    pool = multiprocessing.get_context("spawn").Pool(1)
    try:
        host = pool.apply_async(host_map)
        smoke = Smoke()
        smoke.build.BUILD_ROOT.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=smoke.build.BUILD_ROOT) as tmp:
            fault_build = start_fault_build(smoke.build, tmp)
            try:
                smoke.build.load()
            finally:
                faulty = load_fault(smoke.build, *fault_build)
        info = smoke.build.BUILD_INFO
        result["build_s"] = time.perf_counter() - t0
        print(f"kernel build: {result['build_s']:.2f} s "
              f"(cached={info['cached']}) -> {info['path']}; beside it the "
              f"flash kernel with KV tile {FAULT_TILE} skipped")
        for line in info["log"].splitlines():
            if ("Used" in line and "registers" in line) or "Compiling" in line:
                print(f"  {line.strip()}")

        phase_s["build"] = time.perf_counter() - t_start
        # -- 2. LM path -------------------------------------------------------
        main_calls, launches = {}, {}
        model, prompts, gen_tok = lm_path(smoke, result, launches,
                                          main_calls, faulty)
        flash_kernel = flash_row(smoke, main_calls["flash_attn_bhsd"],
                                 launches["flash_attn_bhsd"])

        phase_s["lm_path"] = time.perf_counter() - t_start
        # -- 3. census, covering, engines -------------------------------------
        t0 = time.perf_counter()
        sc, cov, result["census_s"], result["covering_s"] = host.get()
        result["host_map_wait_s"] = time.perf_counter() - t0
    finally:
        pool.terminate()
        pool.join()
    census = sc.census
    cfg = EngineConfig(mode="exact", cap_boundary=0.5, max_level=MAX_LEVEL)
    # The cascade's caps of examples/quickstart.py.
    scfg = EngineConfig(cap_state=0.5, cap_county=0.5, cap_block=0.5,
                        max_level=MAX_LEVEL)
    specs = {
        "fast": ("fast", cfg),
        "fast_fused": ("fast", dataclasses.replace(cfg, fused=True)),
        "fast_onepass": ("fast_onepass", cfg),
        "simple": ("simple", scfg),
        "simple_fused": ("simple", dataclasses.replace(scfg, fused=True)),
        "hybrid": ("hybrid", EngineConfig(cap_boundary=0.5,
                                          max_level=MAX_LEVEL)),
    }
    t0 = time.perf_counter()
    engines = {name: GeoEngine.build(census, strategy, c, covering=cov)
               for name, (strategy, c) in specs.items()}
    torch.cuda.synchronize()
    result["engines_s"] = time.perf_counter() - t0
    result["footprint"] = engines["fast_onepass"].indices.memory_footprint()
    print(f"host build (a child process, waited for "
          f"{result['host_map_wait_s']:.2f} s after the LM path): census "
          f"{result['census_s']:.2f} s, covering "
          f"{result['covering_s']:.2f} s ({len(cov.lo)} cells, "
          f"{cov.n_boundary} boundary), {len(engines)} engines "
          f"{result['engines_s']:.2f} s; footprint {result['footprint']}")
    for name, eng in engines.items():
        check(eng.device.type == "cuda", f"{name} index not on cuda")
        print(f"  {name}: plan {eng.explain()['strategy']} "
              f"fused={eng.explain()['fused']}")
    sindex = engines["simple"].simple_index
    print(f"  simple index: state_edges {list(sindex.state_edges.shape)}, "
          f"county_edges {list(sindex.county_edges.shape)}, block_edges "
          f"{list(sindex.block_edges.shape)}, county_children "
          f"{list(sindex.county_children.shape)}, block_children "
          f"{list(sindex.block_children.shape)}")

    phase_s["host_build"] = time.perf_counter() - t_start
    # -- 4. kernel phase: each kernel vs its twin, each engine vs the CPU ---
    xy_k, truth_k, *_ = sc.sample_points(np.random.default_rng(1), N_KERNEL)
    pts_k = torch.from_numpy(xy_k).cuda()
    for name, eng in engines.items():
        strategy, c = specs[name]
        cpu_ref = GeoEngine.build(census, strategy, c, covering=cov,
                                  device="cpu").assign(xy_k)
        check(float(np.mean(cpu_ref.block.numpy() == truth_k)) == 1.0,
              f"CPU twin engine {name}: accuracy below 1.0")
        with smoke.capture() as cap:
            res = eng.assign(pts_k)
        torch.cuda.synchronize()
        n_calls = smoke.check_all(cap, f"the {N_KERNEL}-point batch")
        for kname in ENGINE_KERNELS[name]:
            check(n_calls[kname] > 0, f"{name}: {kname} was not called")
        for a, b in zip((res.state, res.county, res.block),
                        (cpu_ref.state, cpu_ref.county, cpu_ref.block)):
            check(torch.equal(a.cpu(), b), f"{name} ids differ from the "
                                           f"CPU twin engine")
        check(res.stats.as_dict() == cpu_ref.stats.as_dict(),
              f"{name} stats {res.stats.as_dict()} differ from the CPU "
              f"twin engine {cpu_ref.stats.as_dict()}")
        print(f"kernel phase: {name}: "
              + ", ".join(f"{k} == twin on {n_calls[k]} call(s)"
                          for k in ENGINE_KERNELS[name])
              + f"; {name} == CPU twin engine (ids, stats)")
    with smoke.capture() as cap:
        pip_one_states(ops, sindex.state_edges, pts_k)
    torch.cuda.synchronize()
    n_calls = smoke.check_all(cap, f"the {N_KERNEL}-point batch")
    check(n_calls["crossings_one"] == sindex.state_edges.shape[0],
          "pip_one: crossings_one not called once per state")
    print(f"kernel phase: crossings_one == twin on "
          f"{n_calls['crossings_one']} call(s) (one per state table)")
    n_blocks = int(engines["fast"].fast_index.block_parent.shape[0])
    result["segment_phase"] = segment_phase(n_blocks)
    worst = max(r["sum_max_rel_err"] for r in result["segment_phase"]
                if r["values"] == "float")
    print(f"kernel phase: segment_reduce_sorted == twin and oracle on "
          f"{len(result['segment_phase'])} cases of {N_KERNEL} rows "
          f"(uniform, skewed 40 %, invalid parked and unparked, S = 1000, "
          f"empty; integer, f32 and no values): count / min / max and "
          f"integer-valued and zero-column sums exact, f32 sums within "
          f"{worst:.3g} of the f64 oracle (rtol {SUM_RTOL}), second launch "
          f"bit-equal")

    phase_s["kernel_phase"] = time.perf_counter() - t_start
    # -- 5. main path ---------------------------------------------------------
    t0 = time.perf_counter()
    xy, truth, _, truth_sid = sc.sample_points(np.random.default_rng(0),
                                               N_MAIN)
    result["sample_s"] = time.perf_counter() - t0
    pts = torch.from_numpy(xy).cuda()
    ids, stats = {}, {}
    result["peak_bytes"], result["checked_in_flight"] = {}, {}
    for name, eng in engines.items():
        keep = [k for k, path in ROW_PATH.items() if path == name]
        torch.cuda.reset_peak_memory_stats()
        with smoke.capture(keep=keep) as cap:
            smoke.build.reset_launches()
            res = eng.assign(pts)
            torch.cuda.synchronize()
            counts = dict(smoke.build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        for kname, n in counts.items():
            want = kname in ENGINE_KERNELS[name]
            check((n > 0) == want, f"{name}: {kname} launched {n} times "
                                   f"(expected {'> 0' if want else '0'})")
        for kname in keep:
            launches[kname] = counts[kname]
            main_calls[kname] = cap.calls[kname]
        # The kept calls are held against their twins in section 7.
        checked = {k: v for k, v in cap.checked.items() if v["calls"]}
        for kname, c in checked.items():
            check(c["max_abs_err"] == 0, f"{kname} differs from its twin "
                  f"(max abs err {c['max_abs_err']}) on the {name} path")
        ids[name] = (res.state, res.county, res.block)
        stats[name] = res.stats.as_dict()
        result["peak_bytes"][name] = peak
        result["checked_in_flight"][name] = checked
        acc = float(np.mean(res.block.cpu().numpy() == truth))
        check(acc == 1.0, f"{name}: accuracy {acc} != 1.0")
        launched = {k: v for k, v in counts.items() if v}
        kept = sum(call_bytes(a, o) for calls in main_calls.values()
                   for a, _, o in calls)
        print(f"main path {name}: launches {launched}, accuracy {acc}, "
              f"peak device memory {peak / 2**30:.2f} GiB (of it, "
              f"{kept / 2**30:.2f} GiB of calls kept for timing), stats "
              f"{stats[name]}")
        for kname, c in checked.items():
            print(f"  {kname} == twin as it ran: {c['calls']} call(s), "
                  f"{c['rows']} rows, {c['bytes'] / 2**30:.2f} GiB")
    blocks = {name: v[2] for name, v in ids.items()}
    check(torch.equal(blocks["fast"], blocks["fast_fused"])
          and torch.equal(blocks["fast"], blocks["fast_onepass"]),
          "the three fast paths' block ids differ")
    check(stats["fast"] == stats["fast_fused"], "fast stats differ")
    check(stats["fast"]["overflow"] == 0
          and stats["fast"]["phase2_miss"] == 0, "fast overflowed")
    for key in ("n_boundary", "n_pip"):
        check(stats["fast_onepass"][key] == stats["fast"][key],
              f"fast_onepass {key} differs")
    check(all(torch.equal(a, b) for a, b in zip(ids["hybrid"], ids["fast"])),
          "hybrid ids differ from fast's")
    check(all(torch.equal(a, b)
              for a, b in zip(ids["simple"], ids["simple_fused"])),
          "simple ids differ from simple fused's")
    check(stats["simple"] == stats["simple_fused"],
          "simple stats differ from simple fused's")
    for name in ("simple", "hybrid"):
        check(stats[name]["overflow"] == 0, f"{name} overflowed")
    result["stats"] = stats
    padded = torch.zeros(PAD_TO, 2, device="cuda")
    padded[:N_PADDED] = pts[:N_PADDED]
    for name, eng in engines.items():
        rp = eng.assign_padded(padded, N_PADDED)
        ru = eng.assign(pts[:N_PADDED])
        for a, b in zip((rp.state, rp.county, rp.block),
                        (ru.state, ru.county, ru.block)):
            check(torch.equal(a[:N_PADDED], b), f"{name} padded ids differ")
            check(bool((a[N_PADDED:] == -1).all()),
                  f"{name} pad rows not -1")
        check(rp.stats.as_dict() == ru.stats.as_dict(),
              f"{name} padded stats differ")
    print(f"assign_padded: {N_PADDED} rows padded to {PAD_TO}: pad rows -1, "
          f"stats equal, on all {len(engines)} paths")
    # ops.pip_one: every point against each state's edge table.
    with smoke.capture() as cap:
        smoke.build.reset_launches()
        inside = pip_one_states(ops, sindex.state_edges, pts)
        torch.cuda.synchronize()
        counts = dict(smoke.build.LAUNCHES)
    check(counts["crossings_one"] == sindex.state_edges.shape[0]
          and sum(counts.values()) == counts["crossings_one"],
          f"pip_one: unexpected launches {counts}")
    launches["crossings_one"] = counts["crossings_one"]
    main_calls["crossings_one"] = cap.calls["crossings_one"]
    pip_sid = torch.where(inside.any(0), inside.int().argmax(0), -1)
    share = float(np.mean(pip_sid.cpu().numpy() == truth_sid))
    result["pip_one_state_share"] = share
    print(f"main path pip_one: launches {counts['crossings_one']} "
          f"(crossings_one), {N_MAIN} points x "
          f"{sindex.state_edges.shape[0]} state tables; share of points "
          f"whose inside-state is the true state: {share}")

    phase_s["main_path"] = time.perf_counter() - t_start
    # -- 5b. analytics path --------------------------------------------------
    from repro_torch.analytics import AnalyticsConfig, BlockAggregator
    from repro_torch.kernels import ref as ref_mod
    from repro_torch.kernels import segment as segment_mod
    agg = BlockAggregator.from_engine(engines["fast"])
    check(agg.n_blocks == n_blocks, "aggregator block count")
    with smoke.capture(keep=["segment_reduce_sorted"]) as cap:
        smoke.build.reset_launches()
        fused = agg.fused_counts(pts)
        torch.cuda.synchronize()
        counts = dict(smoke.build.LAUNCHES)
    for kname, n in counts.items():
        want = kname in ENGINE_KERNELS["fused_counts"]
        check((n > 0) == want, f"fused_counts: {kname} launched {n} times")
    check(counts["segment_reduce_sorted"] == 1,
          "fused_counts: segment_reduce_sorted not launched exactly once")
    for kname, c in cap.checked.items():
        check(c["max_abs_err"] == 0, f"{kname} differs from its twin on "
                                     f"the fused_counts path")
    launches["segment_reduce_sorted"] = counts["segment_reduce_sorted"]
    main_calls["segment_reduce_sorted"] = cap.calls["segment_reduce_sorted"]
    bid_np = blocks["fast"].cpu().numpy()
    expect = np.bincount(bid_np[bid_np >= 0], minlength=n_blocks)
    check(np.array_equal(fused, expect),
          "fused_counts differs from np.bincount of the assigned ids")
    vals_np = np.random.default_rng(4).integers(-50, 50, N_MAIN).astype(
        np.float32)
    vals = torch.from_numpy(vals_np).cuda()
    red = agg.reduce(blocks["fast"], vals)
    oracle = ref_mod.np_segment_reduce(bid_np, vals_np, n_blocks)
    for out, got, want in zip(("count", "sum", "min", "max"), red, oracle):
        check(np.array_equal(got.cpu().numpy(), want),
              f"BlockAggregator.reduce {out} differs from the numpy oracle")
    oidx = engines["fast_onepass"].fast_index
    agg_red, raw = ops.assign_aggregate(
        pts, oidx.quant, oidx.cell_lo, oidx.cell_hi, oidx.cell_val,
        oidx.top_start, oidx.cand, oidx.block_bbox, oidx.edge_pool,
        n_segments=n_blocks, max_level=oidx.max_level, gbits=oidx.gbits,
        search_iters=oidx.search_iters, values=vals)
    check(torch.equal(raw[0], blocks["fast_onepass"]),
          "assign_aggregate's cascade ids differ from fast_onepass's")
    again = ops.segment_reduce(raw[0], vals, n_segments=n_blocks)
    check(all(torch.equal(a, b) for a, b in zip(agg_red, again)),
          "assign_aggregate differs from segment_reduce of its cascade ids")
    check(all(np.array_equal(a.cpu().numpy(), b)
              for a, b in zip(agg_red, oracle)),
          "assign_aggregate differs from the numpy oracle")
    result["fused_counts_active_blocks"] = int((fused > 0).sum())
    print(f"main path fused_counts: launches "
          f"{ {k: v for k, v in counts.items() if v} }; counts == "
          f"np.bincount of fast's ids on {N_MAIN} points "
          f"({result['fused_counts_active_blocks']} of {n_blocks} blocks "
          f"hit); reduce(ids, integer-valued column) == np_segment_reduce; "
          f"assign_aggregate(fast_onepass index) == segment_reduce of its "
          f"cascade ids == oracle")

    phase_s["analytics"] = time.perf_counter() - t_start
    # -- 6. serving path -----------------------------------------------------
    from repro_torch.obs import Tracer
    from repro_torch.serving import GeoServer, ServeConfig
    from repro_torch.serving import server as server_mod
    rng = np.random.default_rng(11)
    xy_s, bid_s, *_ = sc.sample_points(rng, 40_000)
    venue = int(np.bincount(bid_s[bid_s >= 0]).argmax())
    venue_pts = xy_s[bid_s == venue]
    stream, off = [], 0
    for second in range(SERVE_SECONDS):
        req = xy_s[off:off + SERVE_BACKGROUND]
        off += len(req)
        if len(venue_pts) and second >= 4:
            req = np.concatenate([req, venue_pts[rng.integers(
                0, len(venue_pts), SERVE_VENUE)]])
        stream.append((float(second), req))
    stream.append((SERVE_TAIL_T, xy_s[:1]))
    now = [0.0]

    def make_server(engine, cache, tracer=None):
        return GeoServer(engine, ServeConfig(
            buckets=SERVE_BUCKETS, cache=cache, analytics=AnalyticsConfig(
                window_s=8.0, slide_s=2.0, k_anon=5, sketch_bits=2048,
                clock=lambda: now[0])), tracer=tracer)

    def replay(server):
        # Every replay stamps the same request sequence (the analytics
        # source ids), so the distinct-source sketches can be compared.
        server_mod._Ticket._seq = itertools.count()
        out = []
        for ts, req in stream:
            now[0] = ts
            out.append(server.submit(req))
        return out

    tracer = Tracer(sample_rate=1.0)
    srv = make_server(engines["fast"], True, tracer)
    warm_s = srv.warm()
    torch.cuda.synchronize()
    smoke.build.reset_launches()
    t0 = time.perf_counter()
    served = replay(srv)
    torch.cuda.synchronize()
    result["serve_stream_s"] = time.perf_counter() - t0
    counts = dict(smoke.build.LAUNCHES)
    for kname, n in counts.items():
        want = kname in ENGINE_KERNELS["serving"]
        check((n > 0) == want, f"serving: {kname} launched {n} times")
    for (_, req), res in zip(stream, served):
        direct = engines["fast"].assign(req)
        for field in ("state", "county", "block"):
            check(np.array_equal(getattr(res, field),
                                 getattr(direct, field).cpu().numpy()),
                  f"served {field} ids differ from a direct assign")
    served_off = replay(make_server(engines["fast"], False))
    for a, b in zip(served, served_off):
        check(all(np.array_equal(getattr(a, f), getattr(b, f))
                  for f in ("state", "county", "block", "region")),
              "served ids differ with the hot-cell cache off")
    cpu_engine = GeoEngine.build(census, "fast", cfg, covering=cov,
                                 device="cpu")
    cpu_srv = make_server(cpu_engine, True)
    served_cpu = replay(cpu_srv)
    snap = srv.snapshot_analytics()
    check(snap == cpu_srv.snapshot_analytics(),
          "the card server's analytics snapshot differs from the CPU "
          "server's")
    for a, b in zip(served, served_cpu):
        check(np.array_equal(a.block, b.block),
              "served ids differ from the CPU server's")
    region = snap["regions"][0]
    check(region["observed"] == sum(len(r) for _, r in stream),
          "analytics observed count")
    check(region["finalized_total"] > 0, "no analytics window finalized")
    # The busiest window holds 8 requests (8 distinct sources): the venue
    # passes k_anon = 5 there and must top it.
    busiest = max(region["finalized"], key=lambda w: w["n_events"])
    check(busiest["top"] and busiest["top"][0]["block"] == venue,
          "the venue block does not top the busiest finalized window")
    text = srv.metrics_text()
    for stage in SERVE_STAGES:
        check(f'stage_latency_seconds_count{{stage="{stage}"}}' in text,
              f"metrics_text has no {stage} histogram")
    names = {sp.name for sp in tracer.buffer.snapshot()}
    check(SPAN_NAMES <= names, f"spans missing: {SPAN_NAMES - names}")
    result["serve_stream"] = dict(
        requests=len(stream), points=sum(len(r) for _, r in stream),
        warm_s=warm_s, finalized=region["finalized_total"],
        cache=srv.cache_snapshot(), spans=len(tracer.buffer))
    print(f"serving path: {len(stream)} requests "
          f"({result['serve_stream']['points']} points) in "
          f"{result['serve_stream_s']:.3f} s, launches "
          f"{ {k: v for k, v in counts.items() if v} }; ids == direct "
          f"assign, cache on == off, analytics snapshot == CPU server's "
          f"({region['finalized_total']} windows finalized, venue block "
          f"{venue} tops the busiest, [{busiest['start']}, "
          f"{busiest['end']}), with {busiest['top'][0]['count']} points); "
          f"spans {sorted(names)}; cache hit rate "
          f"{srv.cache_snapshot()['hit_rate']:.3f}")
    load = make_server(engines["fast"], True)
    load.warm()
    reqs = xy[:LOAD_REQUESTS * LOAD_POINTS].reshape(LOAD_REQUESTS,
                                                    LOAD_POINTS, 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, req in enumerate(reqs):
        now[0] = 100.0 + 0.05 * i
        load.submit(req)
    load_s = time.perf_counter() - t0
    lat = load.metrics.latency.snapshot_ms()
    stages = load.metrics.snapshot()["stages"]
    result["serve_load"] = dict(
        requests=LOAD_REQUESTS, points_per_request=LOAD_POINTS,
        seconds=load_s, pts_per_s=LOAD_REQUESTS * LOAD_POINTS / load_s,
        latency_ms=lat, stage_p50_ms={k: v["p50"] for k, v in stages.items()},
        cache=load.cache_snapshot())
    print(f"serving load: {LOAD_REQUESTS} requests x {LOAD_POINTS} points "
          f"in {load_s:.3f} s = {result['serve_load']['pts_per_s']:.4g} "
          f"pts/s; request latency p50 {lat['p50']:.3f} ms, p99 "
          f"{lat['p99']:.3f} ms; stage p50 ms "
          f"{ {k: round(v, 3) for k, v in result['serve_load']['stage_p50_ms'].items()} }"
          f"; cache hit rate {load.cache_snapshot()['hit_rate']:.3f}")

    phase_s["serving"] = time.perf_counter() - t_start
    # -- 7. timing ------------------------------------------------------------
    result["pts_per_s"], result["batch_device_ms"] = {}, {}
    for name, eng in engines.items():
        ts, dev = [], []
        for _ in range(TIMED_BATCHES):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            eng.assign(pts)
            end.record()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
            dev.append(start.elapsed_time(end))
        result["pts_per_s"][name] = N_MAIN / float(np.median(ts))
        result["batch_device_ms"][name] = float(np.median(dev))
        print(f"{name}: {result['pts_per_s'][name]:.4g} pts/s (median of "
              f"{TIMED_BATCHES} batches of {N_MAIN}: host "
              f"{[round(t * 1e3, 3) for t in ts]} ms, CUDA events "
              f"{[round(t, 3) for t in dev]} ms)")
    # fused_counts end to end (host clock, synced by the counts' copy to
    # the host) and its parts on the card (CUDA events).
    ts = []
    for _ in range(TIMED_BATCHES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        agg.fused_counts(pts)
        ts.append(time.perf_counter() - t0)
    parked = agg.fused_ids(pts)
    split = {
        "assign": cuda_ms(lambda: engines["fast"].assign(pts), 2),
        "fused_ids": cuda_ms(lambda: agg.fused_ids(pts), 2),
        "sort": cuda_ms(lambda: torch.sort(parked, stable=True),
                        KERNEL_REPS),
        "segment_counts": cuda_ms(lambda: ops.segment_counts(
            parked, n_segments=n_blocks), KERNEL_REPS),
    }
    sk_rng = np.random.default_rng(5)
    skewed = torch.where(torch.from_numpy(sk_rng.random(N_MAIN) < 0.4).cuda(),
                         venue, parked)
    skewed_sorted = torch.sort(skewed, stable=True)[0]
    zeros = torch.zeros(N_MAIN, device="cuda")
    # What reading a value column costs: the kernel on a zero column read
    # from memory against the main path's call, which reads none; their
    # outputs must be equal.
    parked_sorted = torch.sort(parked, stable=True)[0]
    read = segment_mod.segment_reduce_sorted(parked_sorted, zeros, n_blocks)
    unread = segment_mod.segment_reduce_sorted(parked_sorted, None, n_blocks)
    check(all(torch.equal(a, b) for a, b in zip(read, unread)),
          "segment_reduce_sorted: a zero column read differs from none")
    split["kernel_zero_column_read"] = cuda_ms(
        lambda: segment_mod.segment_reduce_sorted(parked_sorted, zeros,
                                                  n_blocks), KERNEL_REPS)
    split["kernel_no_values"] = cuda_ms(
        lambda: segment_mod.segment_reduce_sorted(parked_sorted, None,
                                                  n_blocks), KERNEL_REPS)
    sk_out = segment_mod.segment_reduce_sorted(skewed_sorted, zeros, n_blocks)
    sk_twin = ref_mod.segment_reduce(skewed_sorted, zeros, n_blocks)
    check(max(max_abs_err(a, b, "skewed") for a, b in zip(sk_out, sk_twin))
          == 0, "segment_reduce_sorted differs from its twin on the skewed "
                "2^24 rows")
    split["kernel_skewed"] = cuda_ms(lambda: segment_mod.segment_reduce_sorted(
        skewed_sorted, zeros, n_blocks), KERNEL_REPS)
    hot = int(sk_out[0][venue])
    result["fused_counts"] = dict(
        pts_per_s=N_MAIN / float(np.median(ts)),
        host_ms=[t * 1e3 for t in ts], device_ms=split,
        skewed_hot_rows=hot)
    print(f"fused_counts: {result['fused_counts']['pts_per_s']:.4g} pts/s "
          f"(median of {TIMED_BATCHES} batches of {N_MAIN}: host "
          f"{[round(t * 1e3, 3) for t in ts]} ms); on the card: assign "
          f"{split['assign']:.3f} ms, assign + park {split['fused_ids']:.3f}"
          f" ms, stable sort {split['sort']:.4f} ms (glue), segment_counts "
          f"(park + sort + kernel + normalize) {split['segment_counts']:.4f}"
          f" ms; kernel without values (the counts path) "
          f"{split['kernel_no_values']:.4f} ms, with a zero column read "
          f"{split['kernel_zero_column_read']:.4f} ms, with a zero column "
          f"on skewed ids ({hot} of {N_MAIN} rows in block {venue}) "
          f"{split['kernel_skewed']:.4f} ms")
    phase_s["geo_timing"] = time.perf_counter() - t_start
    lm_timing(model, prompts, gen_tok, result, card)
    phase_s["lm_timing"] = time.perf_counter() - t_start
    kernels = []
    index = engines["fast_onepass"].fast_index
    for kname in KERNELS:
        if kname == "flash_attn_bhsd":
            continue
        calls = main_calls[kname]
        err = smoke.compare(kname, calls)
        check(err == 0, f"{kname} differs from its twin at the main "
                        f"path's inputs (max abs err {err})")
        fn = getattr(smoke.modules[kname], kname)
        ms = cuda_ms(lambda: [fn(*a, **kw) for a, kw, _ in calls],
                     KERNEL_REPS)
        plain = cuda_ms(lambda: [smoke.twin(kname, a, kw)
                                 for a, kw, _ in calls], 2)
        bound, bound_by, nbytes, n_ops = bound_ms(kname, calls, index,
                                                  fast_mod)
        rows = sum(a[0].shape[0] for a, _, _ in calls)
        kernels.append({
            "name": kname, "route": "cuda", "source": KERNELS[kname][0],
            "replaces": KERNELS[kname][1], "launches": launches[kname],
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None})
        print(f"{kname}: {ms:.4f} ms per batch on the {ROW_PATH[kname]} "
              f"path ({len(calls)} call(s), {rows} rows) vs plain twin "
              f"{plain:.3f} ms; bound {bound:.4f} ms by {bound_by} "
              f"({nbytes} B, {n_ops} ops); {bound / ms:.1%} of bound")
    kernels.append(flash_kernel)
    result["kernels"] = kernels
    result["card"] = card
    phase_s["timing"] = time.perf_counter() - t_start
    result["total_s"] = phase_s["timing"]
    result["phase_end_s"] = phase_s
    print(f"smoke ran {result['total_s']:.1f} s; each phase ended at "
          f"{ {k: round(v, 1) for k, v in phase_s.items()} } s")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print("kernels: " + ", ".join(sorted(k["name"] for k in kernels)))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

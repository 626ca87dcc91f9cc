#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (src/repro_torch) on one GPU.

    python3 chip_smoke.py [--out results.json]

Drives the port's mapping, analytics and serving paths through their
public entry points (``GeoEngine.build`` / ``assign`` / ``assign_padded``,
``ops.pip_one``, ``BlockAggregator``, ``ops.assign_aggregate``,
``GeoServer``) on the card:

  1. prints the card (nvidia-smi name and power limit), torch and nvcc
     versions, and builds the CUDA kernels from ``src/repro_torch/
     kernels/csrc`` (build seconds, ptxas register counts);
  2. builds the benchmark-scale census (benchmarks/common.py SCALE:
     16 states / 128 counties / 3,072 blocks), its covering at max_level
     9, and six engines on cuda: ``fast`` (gathered PIP kernel), ``fast``
     with ``fused=True`` (candidate PIP kernel), ``fast_onepass``
     (one-pass cascade kernel), ``simple`` and ``simple`` with
     ``fused=True`` (the bbox kernels, then gathered / candidate PIP per
     level) and ``hybrid`` (the cell lookup, then the simple cascade on
     boundary points);
  3. kernel phase: a 2^16-point batch through each engine, and through
     ``ops.pip_one`` against each state's edge table; every kernel call
     is held against its plain PyTorch twin on the same inputs (exact
     equality), and each engine against a CPU engine of the same config
     (the twins) on ids and stats; ``segment_reduce_sorted`` on 2^16 rows
     of uniform, skewed (40 % in one segment), invalid (parked and
     unparked), odd-``S`` and empty ids: integer-valued and absent (zero)
     columns exact against the twin and the numpy oracle, f32 columns
     within rtol 1e-5 of the oracle, and a second launch bit-equal to
     the first;
  4. main path: 2^24 points through each engine, with every launch
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
  5. serving path: a ``GeoServer`` over ``fast`` with the windowed
     analytics mounted replays examples/analytics_geo.py's stream on
     this map (served ids equal direct assigns, cache on = cache off,
     analytics snapshot equal to a CPU port server's on the same
     requests, spans and histograms for every stage), then serves 256
     requests of 16,384 points (pts/s, p50/p99 request latency);
  6. times each engine (pts/s), ``fused_counts`` (pts/s, and its
     assign / sort / kernel split) and each kernel at the main path's
     inputs beside its plain twin and its bound.

Kernel calls are held against their twins as they happen when their
arguments are too large to keep (the simple path's gathered state edges
are 19 GB a call at 2^24 points); the calls that are timed are kept.
Any failed check raises and the script exits non-zero.  The last line
is the device JSON; the line before it the kernels JSON.  Without a
CUDA device it exits non-zero and prints no result.
"""
import argparse
import contextlib
import dataclasses
import itertools
import json
import os
import subprocess
import sys
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
# NVIDIA H100 SXM data sheet: HBM3 rate, fp32 (non-tensor) peak.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
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
        from repro_torch.kernels import (_build, bbox, cascade, gather_pip,
                                         pip, ref, segment)
        self.build, self.ref = _build, ref
        self.modules = {"assign_cascade": cascade,
                        "crossings_candidates": gather_pip,
                        "crossings_gathered": pip, "crossings_one": pip,
                        "bbox_mask": bbox, "bbox_count_select": bbox,
                        "segment_reduce_sorted": segment}

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
        a number counts inf)."""
        err = 0
        for args, kw, outs in calls:
            for a, b in zip(outs, self.twin(name, args, kw)):
                err = max(err, max_abs_err(a, b, name))
        return err

    def check_all(self, cap, what: str) -> dict:
        """Hold every call of ``cap`` against its twin; return the number
        of calls per kernel."""
        n = {}
        for name in self.modules:
            kept = cap.calls[name]
            err = max(self.compare(name, kept),
                      cap.checked[name]["max_abs_err"])
            check(err == 0, f"{name} differs from its twin (max abs err "
                            f"{err}) on {what}")
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


def pip_one_states(ops, state_edges, pts):
    """[S, N] inside masks of every point against each state's edge
    table, through the public ``ops.pip_one``."""
    return torch.stack([ops.pip_one(pts, state_edges[s])
                        for s in range(state_edges.shape[0])])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the full results as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs only on "
              "the card", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    sys.path.insert(0, os.path.join(REPO, "src"))
    from repro_torch.core import fast as fast_mod
    from repro_torch.core.cells import build_cell_covering
    from repro_torch.core.engine import EngineConfig, GeoEngine
    from repro_torch.core.synth import build_synth_census
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
    smoke = Smoke()
    t0 = time.perf_counter()
    smoke.build.load()
    info = smoke.build.BUILD_INFO
    result["build_s"] = time.perf_counter() - t0
    print(f"kernel build: {result['build_s']:.2f} s "
          f"(cached={info['cached']}) -> {info['path']}")
    for line in info["log"].splitlines():
        if ("Used" in line and "registers" in line) or "Compiling" in line:
            print(f"  {line.strip()}")

    # -- 2. census, covering, engines -----------------------------------------
    t0 = time.perf_counter()
    sc = build_synth_census(**SCALE)
    census = sc.census
    result["census_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cov = build_cell_covering(census, max_level=MAX_LEVEL)
    result["covering_s"] = time.perf_counter() - t0
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
    print(f"host build: census {result['census_s']:.2f} s, covering "
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

    # -- 3. kernel phase: each kernel vs its twin, each engine vs the CPU ---
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

    # -- 4. main path ---------------------------------------------------------
    t0 = time.perf_counter()
    xy, truth, _, truth_sid = sc.sample_points(np.random.default_rng(0),
                                               N_MAIN)
    result["sample_s"] = time.perf_counter() - t0
    pts = torch.from_numpy(xy).cuda()
    main_calls, launches, ids, stats = {}, {}, {}, {}
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
        # The kept calls are held against their twins in section 5.
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

    # -- 4b. analytics path --------------------------------------------------
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

    # -- 5. serving path -----------------------------------------------------
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

    # -- 6. timing ------------------------------------------------------------
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
    kernels = []
    index = engines["fast_onepass"].fast_index
    for kname in KERNELS:
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
    result["kernels"] = kernels
    result["card"] = card
    result["total_s"] = time.perf_counter() - t_start
    print(f"smoke ran {result['total_s']:.1f} s")
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

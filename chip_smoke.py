#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (src/repro_torch) on one GPU.

    python3 chip_smoke.py [--out results.json]

Drives the port's mapping paths through their public entry points
(``GeoEngine.build`` / ``assign`` / ``assign_padded``, ``ops.pip_one``)
on the card:

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
     (the twins) on ids and stats;
  4. main path: 2^24 points through each engine, with every launch
     counter set to 0 just before and read just after (the kernels each
     engine must launch, and no other); block ids equal across the exact
     paths and to ground truth (accuracy 1.0), ``hybrid`` equal to
     ``fast`` id for id, ``simple`` equal to ``simple`` fused in ids and
     stats, no overflow, ``assign_padded`` -1 on its pad rows; then the
     2^24 points against all 16 state tables through ``ops.pip_one``;
  5. times each engine (pts/s) and each kernel at the main path's
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
# NVIDIA H100 SXM data sheet: HBM3 rate, fp32 (non-tensor) peak.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
OPS_PER_EDGE_TEST = 6         # 4 subtractions + 2 products (crosses())
OPS_PER_BOX_TEST = 4          # 4 comparisons (in_box())
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
}
# The main-path run whose calls each kernel's row is measured on.
ROW_PATH = {"assign_cascade": "fast_onepass",
            "crossings_candidates": "fast_fused",
            "crossings_gathered": "fast", "bbox_mask": "simple",
            "bbox_count_select": "simple", "crossings_one": "pip_one"}
# Positional arguments of each kernel wrapper that are per-row.
ROW_ARGS = {"assign_cascade": (0,), "crossings_candidates": (0, 1, 2),
            "crossings_gathered": (0, 1), "crossings_one": (0,),
            "bbox_mask": (0,), "bbox_count_select": (0, 1)}


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
    after one warm run)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


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
                                         pip, ref)
        self.build, self.ref = _build, ref
        self.modules = {"assign_cascade": cascade,
                        "crossings_candidates": gather_pip,
                        "crossings_gathered": pip, "crossings_one": pip,
                        "bbox_mask": bbox, "bbox_count_select": bbox}

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

    def compare(self, name, calls) -> int:
        """Max |kernel - twin| over every output of every call."""
        err = 0
        for args, kw, outs in calls:
            for a, b in zip(outs, self.twin(name, args, kw)):
                check(a.shape == b.shape and a.dtype == b.dtype,
                      f"{name}: output {a.shape}/{a.dtype} vs twin "
                      f"{b.shape}/{b.dtype}")
                if a.numel():
                    err = max(err, int((a.long() - b.long()).abs().max()))
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


def bound_ms(name, calls, index, fast_mod) -> tuple:
    """Least time for the work of ``calls`` on an H100: the larger of the
    bytes moved (each input read once, each output written once) over
    the HBM rate and the operations (crossing tests, box tests) over the
    fp32 peak."""
    nbytes = ops = 0
    for args, kw, outs in calls:
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

    # -- 5. timing ------------------------------------------------------------
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

#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (src/repro_torch) on one GPU.

    python3 chip_smoke.py [--out results.json]

Drives the port's exact fast path through its public entry points
(``GeoEngine.build`` / ``assign`` / ``assign_padded``) on the card:

  1. prints the card (nvidia-smi name and power limit), torch and nvcc
     versions, and builds the CUDA kernels from ``src/repro_torch/
     kernels/csrc`` (build seconds, ptxas register counts);
  2. builds the benchmark-scale census (benchmarks/common.py SCALE:
     16 states / 128 counties / 3,072 blocks), its covering at max_level
     9, and three engines on cuda: ``fast`` (gathered PIP kernel),
     ``fast`` with ``fused=True`` (candidate PIP kernel) and
     ``fast_onepass`` (one-pass cascade kernel);
  3. kernel phase: a 2^16-point batch through each engine; every kernel
     call is held against its plain PyTorch twin on the same inputs
     (exact equality), and each engine against a CPU engine (the twins)
     on ids and stats;
  4. main path: 2^24 points through each engine, with every launch
     counter set to 0 just before and read just after; the three block
     id vectors must be equal and match ground truth (accuracy 1.0),
     the GeoStats counters must agree, and ``assign_padded`` must return
     -1 on its pad rows;
  5. times each engine (pts/s) and each kernel at the main path's
     inputs beside its plain twin and its bound.

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
KERNELS = {
    "assign_cascade": ("src/repro_torch/kernels/csrc/cascade.cu",
                       "src/repro/kernels/cascade.py:224"),
    "crossings_candidates": ("src/repro_torch/kernels/csrc/gather_pip.cu",
                             "src/repro/kernels/gather_pip.py:151"),
    "crossings_gathered": ("src/repro_torch/kernels/csrc/pip.cu",
                           "src/repro/kernels/pip.py:113"),
}
ENGINE_KERNEL = {"fast": "crossings_gathered",
                 "fast_fused": "crossings_candidates",
                 "fast_onepass": "assign_cascade"}
# Positional arguments of each kernel wrapper that are per-row.
ROW_ARGS = {"assign_cascade": (0,), "crossings_candidates": (0, 1, 2),
            "crossings_gathered": (0, 1)}


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


class Smoke:
    def __init__(self):
        from repro_torch.kernels import _build, cascade, gather_pip, pip, ref
        self.build, self.ref = _build, ref
        self.modules = {"assign_cascade": cascade,
                        "crossings_candidates": gather_pip,
                        "crossings_gathered": pip}

    @contextlib.contextmanager
    def capture(self):
        """Record every kernel-wrapper call (args, kwargs, outputs) made
        through ``ops`` inside the block; the calls still launch."""
        calls = {name: [] for name in self.modules}
        saved = {name: getattr(m, name) for name, m in self.modules.items()}

        def recorder(name, fn):
            def rec(*args, **kw):
                out = fn(*args, **kw)
                calls[name].append((args, kw, out if isinstance(out, tuple)
                                    else (out,)))
                return out
            return rec

        for name, m in self.modules.items():
            setattr(m, name, recorder(name, saved[name]))
        try:
            yield calls
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
            if name == "crossings_gathered":
                out = (ref.crossings_gathered(*a),)
            elif name == "crossings_candidates":
                first, nblk, points, blocks = a
                out = (ref.crossings_candidates(points, first, nblk, blocks,
                                                kw["max_blocks"]),)
            else:
                count = a[9]
                out = ref.assign_cascade(
                    *a, **kw, max_blocks=max(int(count.max()), 1))
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
    the HBM rate and the crossing-test operations over the fp32 peak."""
    nbytes = ops = 0
    for args, kw, outs in calls:
        nbytes += sum(t.numel() * t.element_size()
                      for t in list(args) + list(outs)
                      if isinstance(t, torch.Tensor))
        if name == "crossings_gathered":
            ops += args[1].shape[0] * args[1].shape[1] * OPS_PER_EDGE_TEST
        elif name == "crossings_candidates":
            ops += (int(args[1].sum()) * args[3].shape[2]
                    * OPS_PER_EDGE_TEST)
        else:
            bid, flags, _, nskip = outs
            ops += cascade_edge_tests(fast_mod, index, args[0], bid, flags,
                                      nskip) * OPS_PER_EDGE_TEST
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, ops)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the full results as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs only on "
              "the card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(REPO, "src"))
    from repro_torch.core import fast as fast_mod
    from repro_torch.core.cells import build_cell_covering
    from repro_torch.core.engine import EngineConfig, GeoEngine
    from repro_torch.core.synth import build_synth_census

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
        if "Used" in line and "registers" in line:
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
    t0 = time.perf_counter()
    engines = {
        "fast": GeoEngine.build(census, "fast", cfg, covering=cov),
        "fast_fused": GeoEngine.build(
            census, "fast", dataclasses.replace(cfg, fused=True),
            covering=cov),
        "fast_onepass": GeoEngine.build(census, "fast_onepass", cfg,
                                        covering=cov),
    }
    torch.cuda.synchronize()
    result["engines_s"] = time.perf_counter() - t0
    result["footprint"] = engines["fast_onepass"].indices.memory_footprint()
    print(f"host build: census {result['census_s']:.2f} s, covering "
          f"{result['covering_s']:.2f} s ({len(cov.lo)} cells, "
          f"{cov.n_boundary} boundary), 3 engines {result['engines_s']:.2f} s;"
          f" footprint {result['footprint']}")
    for name, eng in engines.items():
        check(eng.device.type == "cuda", f"{name} index not on cuda")
        print(f"  {name}: plan {eng.explain()['strategy']} "
              f"fused={eng.explain()['fused']}")

    # -- 3. kernel phase: each kernel vs its twin, each engine vs the CPU ---
    xy_k, truth_k, *_ = sc.sample_points(np.random.default_rng(1), N_KERNEL)
    cpu_ref = GeoEngine.build(census, "fast", cfg, covering=cov,
                              device="cpu").assign(xy_k)
    pts_k = torch.from_numpy(xy_k).cuda()
    for name, eng in engines.items():
        kname = ENGINE_KERNEL[name]
        with smoke.capture() as calls:
            res = eng.assign(pts_k)
        torch.cuda.synchronize()
        check(len(calls[kname]) > 0, f"{name}: {kname} was not called")
        err = smoke.compare(kname, calls[kname])
        check(err == 0, f"{kname} differs from its twin (max abs err "
                        f"{err}) on the {N_KERNEL}-point batch")
        for a, b in zip((res.state, res.county, res.block),
                        (cpu_ref.state, cpu_ref.county, cpu_ref.block)):
            check(torch.equal(a.cpu(), b), f"{name} ids differ from the "
                                           f"CPU twin engine")
        check(res.stats.as_dict() == cpu_ref.stats.as_dict(),
              f"{name} stats {res.stats.as_dict()} differ from the CPU "
              f"twin engine {cpu_ref.stats.as_dict()}")
        print(f"kernel phase: {kname} == twin on {len(calls[kname])} "
              f"call(s); {name} == CPU twin engine (ids, stats)")
    check(float(np.mean(cpu_ref.block.numpy() == truth_k)) == 1.0,
          "CPU twin engine accuracy below 1.0")

    # -- 4. main path ---------------------------------------------------------
    t0 = time.perf_counter()
    xy, truth, *_ = sc.sample_points(np.random.default_rng(0), N_MAIN)
    result["sample_s"] = time.perf_counter() - t0
    pts = torch.from_numpy(xy).cuda()
    main_calls, launches, blocks, stats = {}, {}, {}, {}
    for name, eng in engines.items():
        with smoke.capture() as calls:
            smoke.build.reset_launches()
            res = eng.assign(pts)
            torch.cuda.synchronize()
            counts = dict(smoke.build.LAUNCHES)
        kname = ENGINE_KERNEL[name]
        check(counts[kname] > 0, f"{name}: {kname} launched 0 times")
        check(all(v == 0 for k, v in counts.items() if k != kname),
              f"{name}: unexpected launches {counts}")
        launches[kname] = counts[kname]
        main_calls[kname] = calls[kname]
        blocks[name] = res.block
        stats[name] = res.stats.as_dict()
        acc = float(np.mean(res.block.cpu().numpy() == truth))
        check(acc == 1.0, f"{name}: accuracy {acc} != 1.0")
        print(f"main path {name}: launches {counts}, accuracy {acc}, "
              f"stats {stats[name]}")
    check(torch.equal(blocks["fast"], blocks["fast_fused"])
          and torch.equal(blocks["fast"], blocks["fast_onepass"]),
          "the three paths' block ids differ")
    check(stats["fast"] == stats["fast_fused"], "fast stats differ")
    check(stats["fast"]["overflow"] == 0
          and stats["fast"]["phase2_miss"] == 0, "fast overflowed")
    for key in ("n_boundary", "n_pip"):
        check(stats["fast_onepass"][key] == stats["fast"][key],
              f"fast_onepass {key} differs")
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
          f"stats equal, on all three paths")

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
    for kname, calls in main_calls.items():
        err = smoke.compare(kname, calls)
        check(err == 0, f"{kname} differs from its twin at the main "
                        f"path's inputs (max abs err {err})")
        mod = smoke.modules[kname]
        fn = getattr(mod, kname)
        ms = cuda_ms(lambda: [fn(*a, **kw) for a, kw, _ in calls],
                     KERNEL_REPS)
        plain = cuda_ms(lambda: [smoke.twin(kname, a, kw)
                                 for a, kw, _ in calls], 2)
        bound, bound_by, nbytes, ops = bound_ms(kname, calls, index,
                                                fast_mod)
        rows = sum(a[0].shape[0] for a, _, _ in calls)
        kernels.append({
            "name": kname, "route": "cuda", "source": KERNELS[kname][0],
            "replaces": KERNELS[kname][1], "launches": launches[kname],
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None})
        print(f"{kname}: {ms:.4f} ms per batch ({len(calls)} call(s), "
              f"{rows} rows) vs plain twin {plain:.3f} ms; bound "
              f"{bound:.4f} ms by {bound_by} ({nbytes} B, {ops} ops); "
              f"{bound / ms:.1%} of bound")
    result["kernels"] = kernels
    result["card"] = card
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

"""Device time of exact ``fast``'s two data paths on the benchmark's cells,
by the program's ``geo.*`` spans, on one GPU.

    python3 scripts/fast_paths_trace.py [--cells synth3k_fast.inblock ...]
        [--seed 7] [--batches 16] [--out chiprun_out/fast_paths.json]

For each cell (``BENCHMARK.json``'s, built and loaded as ``bench/run.py``
builds them), two engines over one loaded artifact: ``gathered``, pinned
to ``fast`` with ``fused=False`` (the cell search, compaction, gathers
and ``crossings_gathered``), and ``auto``, the planner's choice.  Each
runs three warm batches of the cell's traffic, then ``--batches`` batches
under ``torch.profiler``.  Printed, and written as JSON to ``--out``: the
plan, device ms a batch (busy, and the traced stretch's wall time), the
device ms under each ``geo.*`` span (``bench/spans.py``: a kernel counts
under every span its launch lies in), the share of batches that ran
under ``geo.fast.onepass``, the top device operations and idle gaps,
``n_need`` / ``n_pip`` / ``overflow`` summed over the traced batches
(equal on both paths where nothing overflows), ``bbox_skips`` per
boundary point, whether both paths gave the same ids, and on the
one-pass path the kernel's time split into its locate and its candidate
walk (``kernel_split``, CUDA events).  Needs a CUDA
device; it prints the card's name and power limit beside the numbers.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile

import torch
from torch.profiler import ProfilerActivity, profile, record_function

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = ("synth3k_fast.inblock", "paper221k_fast.inblock")
SPANS = ("geo.assign", "geo.fast.locate", "geo.fast.onepass",
         "geo.fast.parents", "geo.resolve", "geo.resolve.compact",
         "geo.resolve.candidates", "geo.resolve.pip", "geo.resolve.scatter")


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return torch.cuda.get_device_name(0)


def traced(engine, pool, n, dev):
    """(SpanTrace, counters, ids) of ``n`` batches under the profiler."""
    from bench import spans, trace as bench_trace
    from repro_torch.kernels import _build
    results = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(bench_trace.STRETCH):
            for b in range(n):
                with record_function("assign"):
                    results.append(engine.assign(pool[b % len(pool)]))
                with record_function("wait"):
                    torch.cuda.synchronize(dev)
    sums = {k: sum(int(getattr(r.stats, k)) for r in results)
            for k in ("n_need", "n_pip", "overflow")}
    sums["bbox_skips"] = sum(int(r.stats.extra.get("bbox_skips", 0))
                             for r in results)
    ids = [r.block for r in results[:len(pool)]]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        tr = spans.SpanTrace.from_file(
            path, bench_trace.global_names(_build.CSRC))
    return tr, sums, ids


def kernel_split(index, pts, reps=10):
    """(ms, locate-only ms) of one ``assign_cascade`` launch on ``pts``
    (CUDA events over ``reps`` launches): the kernel as the route runs
    it, and with every candidate slot -1, so that boundary points are
    queued but walk no candidate.  The difference is the candidate walk
    (bbox gate and edge stage)."""
    from repro_torch.kernels import ops

    def timed(cand):
        def launch():
            ops.assign_cascade(
                pts, index.quant, index.cell_lo, index.cell_hi,
                index.cell_val, index.top_start, cand, index.block_bbox,
                index.edge_pool, max_level=index.max_level,
                gbits=index.gbits, search_iters=index.search_iters)
        launch()
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        for _ in range(reps):
            launch()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    return timed(index.cand), timed(torch.full_like(index.cand, -1))


def one_path(name, engine, pool, n, dev):
    from bench import spans
    for b in range(3):
        engine.assign(pool[b % len(pool)])
    torch.cuda.synchronize(dev)
    tr, sums, ids = traced(engine, pool, n, dev)
    batches = tr.batches()
    onepass = sum(1 for s, ts, _ in tr.spans if s == "geo.fast.onepass"
                  and tr.t0 <= ts < tr.t1)
    out = {
        "plan": {k: engine.explain()[k] for k in ("strategy", "fused",
                                                  "reasons")},
        "batches": batches,
        "device_ms_per_batch": tr.busy_us() / 1e3 / batches,
        "window_ms_per_batch": tr.window_us / 1e3 / batches,
        "span_ms_per_batch": {s: spans.ms_per_batch(tr, s) for s in SPANS},
        "host_syncs_per_batch": spans.host_syncs_per_batch(tr),
        "onepass_batch_share": 100.0 * onepass / batches,
        "counters": sums,
        "bbox_skips_per_boundary_pt": (sums["bbox_skips"] / sums["n_need"]
                                       if sums["n_need"] else None),
        "top_ops": tr.top_ops(),
        "idle_gaps": tr.idle_gaps(5),
    }
    if engine.plan.fused == "onepass":
        whole, locate = kernel_split(engine.fast_index, pool[0])
        out["kernel_split_ms"] = {"kernel": whole, "locate_only": locate,
                                  "walk": whole - locate}
        print(f"  {name}: assign_cascade {whole:.3f} ms, with no "
              f"candidates {locate:.3f} ms (CUDA events)")
    print(f"  {name}: plan {out['plan']['strategy']} "
          f"fused={out['plan']['fused']}; device "
          f"{out['device_ms_per_batch']:.3f} ms a batch (window "
          f"{out['window_ms_per_batch']:.3f}); spans "
          + ", ".join(f"{s} {v:.3f}" for s, v in
                      out["span_ms_per_batch"].items() if v)
          + f"; onepass batches {out['onepass_batch_share']:.1f} %; "
          f"counters {sums}")
    return out, ids


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", nargs="+", default=list(CELLS))
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--batches", type=int, default=16)
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                  "fast_paths.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fast_paths_trace: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [os.path.join(REPO, "src"), REPO]
    from bench import generate, harness
    from repro_torch.core.artifact import GeoIndexSet
    from repro_torch.core.engine import EngineConfig, GeoEngine
    dev = torch.device("cuda")
    result = {"card": card(), "seed": args.seed, "cells": {}}
    print(f"card: {result['card']}")
    spec = harness.Spec(REPO)
    for cell in args.cells:
        wl = spec.workload(cell)
        cfg = spec.config(wl["config"])
        art, _ = harness.ensure_artifact(spec.root, cfg)
        idx = GeoIndexSet.load(str(art / "artifact"), device=dev)
        pool = generate.make_pool(harness.load_census(art),
                                  spec.mix(wl["traffic"]), args.seed,
                                  int(cfg["batch_points"]), dev)
        print(f"{cell}:")
        paths, ids = {}, {}
        for name, strategy in (("gathered", "fast"),
                               ("auto", cfg["strategy"])):
            engine = GeoEngine.from_index_set(idx, strategy,
                                              EngineConfig(mode=cfg["mode"]))
            paths[name], ids[name] = one_path(name, engine, pool,
                                              args.batches, dev)
            del engine
        paths["same_ids"] = all(torch.equal(a, b) for a, b in
                                zip(ids["gathered"], ids["auto"]))
        print(f"  same ids on both paths: {paths['same_ids']}")
        result["cells"][cell] = paths
        del idx, pool, ids
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Where the time goes in the PyTorch port's mapping paths, on one GPU.

    python3 scripts/torch_profile.py [--n 16777216]

Builds the benchmark-scale census (benchmarks/common.py SCALE) and its
covering at max_level 9, printing the host ms of the build's
``geo.cells.build`` span and of each level's ``geo.cells.level``, then
for each path (``fast``, ``fast`` with
``fused=True``, ``fast_onepass``, ``simple``, ``simple`` with
``fused=True``, ``hybrid``; the configs of chip_smoke.py) runs one warm
batch of ``--n`` points under ``torch.profiler`` and prints the wall
time of the batch, the device time summed over its kernels (busy share
= device / wall), the operators and kernels with the most device time,
and the device time under each of the engine's ``geo.*`` phase spans
(``bench/spans.py``'s reading: a kernel counts under every span its
launch lies in), with the host syncs inside ``geo.assign``.  Needs a
CUDA device.
"""
import argparse
import dataclasses
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALE = dict(seed=0, n_states=16, counties_per_state=8, blocks_per_county=24)
TOP = 10


def device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 24)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [os.path.join(REPO, "src"), REPO]
    from bench import spans, trace as bench_trace
    from repro_torch.core.cells import build_cell_covering
    from repro_torch.core.engine import EngineConfig, GeoEngine
    from repro_torch.core.synth import build_synth_census

    sc = build_synth_census(**SCALE)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        cov = build_cell_covering(sc.census, max_level=9)
    build = [e.cpu_time_total / 1e3 for e in prof.events()
             if e.name == "geo.cells.build"]
    levels = [e.cpu_time_total / 1e3 for e in prof.events()
              if e.name == "geo.cells.level"]
    print(f"== covering build: geo.cells.build {sum(build):.3f} ms (host), "
          f"{len(cov.lo)} cells, {cov.n_boundary} boundary, "
          f"{cov.nbytes()} bytes; geo.cells.level by level (ms): "
          + " ".join(f"{ms:.3f}" for ms in levels))
    cfg = EngineConfig(mode="exact", cap_boundary=0.5)
    scfg = EngineConfig(cap_state=0.5, cap_county=0.5, cap_block=0.5)
    specs = {
        "fast": ("fast", cfg),
        "fast_fused": ("fast", dataclasses.replace(cfg, fused=True)),
        "fast_onepass": ("fast_onepass", cfg),
        "simple": ("simple", scfg),
        "simple_fused": ("simple", dataclasses.replace(scfg, fused=True)),
        "hybrid": ("hybrid", EngineConfig(cap_boundary=0.5)),
    }
    xy, *_ = sc.sample_points(np.random.default_rng(0), args.n)
    pts = torch.from_numpy(xy).cuda()
    for name, (strategy, c) in specs.items():
        eng = GeoEngine.build(sc.census, strategy, c, covering=cov)
        eng.assign(pts)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(bench_trace.STRETCH):
                t0 = time.perf_counter()
                eng.assign(pts)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            tr = spans.SpanTrace.from_file(path, set())
        # Kernels from the trace's device events: key_averages() also
        # lists each span's projection onto the device as a CUDA row.
        kernels = {}
        for kname, _, ts, te in tr.device:
            us, count = kernels.get(kname, (0.0, 0))
            kernels[kname] = (us + te - ts, count + 1)
        kernels = sorted(((us, count, kname) for kname, (us, count)
                          in kernels.items()), reverse=True)
        ops = sorted(((device_us(e), e.count, e.key)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CPU), reverse=True)
        busy = tr.device_us() / 1e3
        print(f"== {name}: wall {wall * 1e3:.3f} ms, device {busy:.3f} ms "
              f"(busy {busy / (wall * 1e3):.1%}), {args.n} points, "
              f"{len(kernels)} distinct kernels, "
              f"{sum(k[1] for k in kernels)} launches")
        for title, rows in (("operators", ops), ("kernels", kernels)):
            print(f"  top {title} by device time:")
            for us, count, key in rows[:TOP]:
                if us <= 0:
                    break
                print(f"  {us / 1e3:9.3f} ms  {us / 1e3 / busy:6.1%}  "
                      f"x{count:<4d} {key[:80]}")
        print(f"  device time by geo.* span ({tr.span_calls(spans.SYNC_CALLS)}"
              f" host syncs inside geo.assign; "
              f"{spans.unspanned_share(tr) or 0.0:.2f} % of geo.assign's "
              f"device time under no leaf span):")
        for n in dict.fromkeys(n for n, _, _ in tr.spans):
            us = tr.span_device_us(n)
            print(f"  {us / 1e3:9.3f} ms  {us / 1e3 / busy:6.1%}  "
                  f"x{sum(1 for s in tr.spans if s[0] == n):<4d} {n}")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())

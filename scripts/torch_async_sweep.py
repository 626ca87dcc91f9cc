"""The port's served throughput and latency, sync against async, on one GPU.

    python3 scripts/torch_async_sweep.py [--requests 256] [--points 16384]

Builds the benchmark-scale census (benchmarks/common.py SCALE) and its
covering at max_level 9, a ``fast`` engine on the card (chip_smoke.py's
config) and serves the same requests (the first ``--requests`` x
``--points`` of a seed-0 sample) with chip_smoke.py's phase 6
ServeConfig (buckets 1,024 / 4,096 / 16,384, the hot-cell cache, the
windowed analytics mounted):

  * ``sync``: ``GeoServer``, one request at a time (and ``sync, no
    cache`` with the hot-cell cache off);
  * ``burst rN``: ``AsyncGeoServer`` with 4 submitters and N replicas,
    every request submitted at once from 8 client threads (open loop:
    a request's latency includes its time in the queue);
  * ``closed r2``: 8 client threads, each waiting for its request before
    sending the next (closed loop);
  * ``burst r2, no cache``: the burst with the cache off (a lighter
    host stage).

For each it prints pts/s (points over the wall time from the first
submit to the last result), request latency p50 / p99 and the per-stage
p50 of ``ServerMetrics``, after checking every request's ids against a
direct assign.  The last line is a JSON object of the rows.  Needs a
CUDA device.
"""
import argparse
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALE = dict(seed=0, n_states=16, counties_per_state=8, blocks_per_county=24)
BUCKETS = (1024, 4096, 16384)
CLIENTS, SUBMITTERS = 8, 4


def serve_cfg(cache: bool):
    from repro_torch.analytics import AnalyticsConfig
    from repro_torch.serving import ServeConfig
    return ServeConfig(buckets=BUCKETS, cache=cache,
                       analytics=AnalyticsConfig(
                           window_s=8.0, slide_s=2.0, k_anon=5,
                           sketch_bits=2048, clock=lambda: 100.0))


def row(name, server, reqs, seconds, results, want):
    got = np.concatenate([r.block for r in results])
    if not np.array_equal(got, want):
        raise SystemExit(f"{name}: served ids differ from a direct assign")
    snap = server.metrics.snapshot()
    for field in ("failed_flushes", "failed_requests", "shed_requests"):
        if snap["counters"].get(field, 0):
            raise SystemExit(f"{name}: {field} {snap['counters'][field]}")
    lat = server.metrics.latency.snapshot_ms()
    out = dict(name=name, seconds=seconds,
               pts_per_s=reqs.shape[0] * reqs.shape[1] / seconds,
               p50_ms=lat["p50"], p99_ms=lat["p99"],
               stage_p50_ms={k: v["p50"] for k, v in snap["stages"].items()})
    print(f"{name}: {out['pts_per_s']:.4g} pts/s ({seconds:.3f} s); request "
          f"latency p50 {lat['p50']:.3f} ms, p99 {lat['p99']:.3f} ms; stage "
          f"p50 ms { {k: round(v, 3) for k, v in out['stage_p50_ms'].items()} }")
    return out


def burst(srv, reqs):
    futures = [None] * len(reqs)

    def client(c):
        for i in range(c, len(reqs), CLIENTS):
            futures[i] = srv.submit_async(reqs[i])

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    results = [f.result(timeout=600) for f in futures]
    torch.cuda.synchronize()
    return time.perf_counter() - t0, results


def closed(srv, reqs):
    results = [None] * len(reqs)

    def client(c):
        for i in range(c, len(reqs), CLIENTS):
            results[i] = srv.submit(reqs[i], timeout=600)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, results


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=256)
    ap.add_argument("--points", type=int, default=16384)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_async_sweep: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(REPO, "src"))
    from repro_torch.core.cells import build_cell_covering
    from repro_torch.core.engine import EngineConfig, GeoEngine
    from repro_torch.core.synth import build_synth_census
    from repro_torch.serving import AsyncGeoServer, FrontendConfig, GeoServer

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(card)
    sc = build_synth_census(**SCALE)
    cov = build_cell_covering(sc.census, max_level=9)
    engine = GeoEngine.build(sc.census, "fast",
                             EngineConfig(mode="exact", cap_boundary=0.5),
                             covering=cov)
    xy, *_ = sc.sample_points(np.random.default_rng(0),
                              args.requests * args.points)
    reqs = xy.reshape(args.requests, args.points, 2)
    want = engine.assign(xy).block.cpu().numpy()
    rows = []

    for name, cache in (("sync", True), ("sync, no cache", False)):
        srv = GeoServer(engine, serve_cfg(cache))
        srv.warm()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = [srv.submit(r) for r in reqs]
        torch.cuda.synchronize()
        rows.append(row(name, srv, reqs, time.perf_counter() - t0, results,
                        want))
    for name, cache, replicas, drive in (
            ("burst r1", True, 1, burst), ("burst r2", True, 2, burst),
            ("burst r4", True, 4, burst), ("closed r2", True, 2, closed),
            ("burst r2, no cache", False, 2, burst)):
        with AsyncGeoServer(engine, serve_cfg(cache),
                            frontend=FrontendConfig(
                                n_submitters=SUBMITTERS,
                                n_replicas=replicas)) as srv:
            srv.warm()
            torch.cuda.synchronize()
            seconds, results = drive(srv, reqs)
            rows.append(row(name, srv, reqs, seconds, results, want))
    print(card)
    print(json.dumps({"card": card, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

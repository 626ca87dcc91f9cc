"""Serving quickstart on the PyTorch + CUDA port: GeoServer over a
synthetic census — micro-batched mixed-size requests, hot-cell caching,
deadline flushes, live metrics, artifact cold start, the concurrent
AsyncGeoServer, and a two-region router (DESIGN.md §10, §11, §14).

    PYTHONPATH=src python examples/torch_serve_geo.py               # cuda
    PYTHONPATH=src python examples/torch_serve_geo.py --device cpu
"""
import argparse
import json
import tempfile

import numpy as np

from repro_torch.core.engine import EngineConfig, GeoEngine
from repro_torch.core.synth import build_synth_census
from repro_torch.serving import (AsyncGeoServer, FrontendConfig, GeoServer,
                                 ServeConfig)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = args.device
    # 1. Build a census and a serving engine.  strategy="auto" lets the
    #    planner pick; max_delay_ms bounds how long a trickle request can
    #    sit in the queue before a flush fires (latency SLO).
    print("building synthetic census...")
    sc = build_synth_census(seed=0, n_states=16, counties_per_state=8,
                            blocks_per_county=24)
    engine = GeoEngine.build(sc.census, "auto",
                             EngineConfig(cap_boundary=0.5), device=dev)
    print(f"planner chose {engine.explain()['strategy']!r} on {dev}")
    server = GeoServer(engine, ServeConfig(buckets=(256, 1024, 4096),
                                           max_delay_ms=50.0))

    # 2. Warm: pre-pay every bucket's first run before traffic arrives.
    print("warming buckets:", {b: f"{t:.2f}s"
                               for b, t in server.warm().items()})

    # 3. A bursty request stream: mixed sizes, 30% re-queries of a hot
    #    pool (popular venues) — the hot-cell cache's home turf.
    rng = np.random.default_rng(7)
    xy, bid, *_ = sc.sample_points(rng, 50_000)
    hot = xy[rng.choice(len(xy), 128, replace=False)]
    served = correct = 0
    off = 0
    while off < len(xy):
        if rng.uniform() < 0.3:
            req = hot[rng.integers(0, len(hot), 64)]
            res = server.submit(req)
        else:
            size = int(rng.integers(1, 4096))
            req, truth = xy[off:off + size], bid[off:off + size]
            res = server.submit(req)
            correct += int(np.sum(res.block == truth))
            off += len(req)
        served += len(req)
    print(f"served {served} points; batch-stream accuracy "
          f"{correct / off:.4f}")

    # 4. The live metrics snapshot (what a /metrics endpoint would serve).
    print(json.dumps(server.snapshot(), indent=2, sort_keys=True))

    # 5. Cold start: persist the index artifact once, then bring up a
    #    fresh server from disk — no covering build on the restart path.
    #    The artifact stores geometry, not engine knobs: pass the same
    #    EngineConfig for bit-identical serving.
    probe = xy[:512]
    with tempfile.TemporaryDirectory() as tmp:
        engine.indices.save(tmp)
        cold = GeoServer.from_artifact(tmp, strategy="auto",
                                       engine_cfg=engine.cfg,
                                       cfg=ServeConfig(buckets=(256, 1024)),
                                       device=dev)
        same = np.array_equal(cold.submit(probe).block,
                              server.submit(probe).block)
        print(f"cold-started server from artifact: bit-identical={same}")

    # 6. The concurrent front end: futures from many clients, batches
    #    coalesced across them, two replica workers on the device stage.
    with AsyncGeoServer(engine, ServeConfig(buckets=(256, 1024, 4096)),
                        frontend=FrontendConfig(n_submitters=4,
                                                n_replicas=2)) as srv:
        futures = [srv.submit_async(xy[i:i + 700])
                   for i in range(0, 14_000, 700)]
        blocks = np.concatenate([f.result(timeout=60).block
                                 for f in futures])
        direct = engine.assign(xy[:14_000]).block.cpu().numpy()
        print(f"async server: {len(futures)} futures resolved; "
              f"bit-identical={np.array_equal(blocks, direct)}")

    # 7. Multi-region routing: two regional engines behind one submit().
    scW = build_synth_census(seed=3, n_states=4, counties_per_state=4,
                             blocks_per_county=8,
                             extent=(-120.0, -100.0, 30.0, 45.0))
    scE = build_synth_census(seed=4, n_states=4, counties_per_state=4,
                             blocks_per_county=8,
                             extent=(-100.0, -80.0, 30.0, 45.0))
    router = GeoServer(
        [GeoEngine.build(scW.census, "fast", device=dev),
         GeoEngine.build(scE.census, "fast", device=dev)],
        ServeConfig(buckets=(256, 1024)))
    xyW, *_ = scW.sample_points(rng, 300)
    xyE, *_ = scE.sample_points(rng, 300)
    nowhere = np.array([[-150.0, 10.0]], np.float32)
    res = router.submit(np.concatenate([xyW, xyE, nowhere]))
    counts = {int(r): int(n) for r, n in
              zip(*np.unique(res.region, return_counts=True))}
    print(f"router: {counts[0]} points -> region 0 (west), "
          f"{counts[1]} -> region 1 (east), "
          f"{counts.get(-1, 0)} in no region (block "
          f"{res.block[-1]})")


if __name__ == "__main__":
    main()

"""Streaming analytics quickstart on the PyTorch + CUDA port (twin of
examples/analytics_geo.py): a GeoServer with the windowed analytics
mount — point traffic becomes per-block occupancy windows, crowding
density, top-k crowded blocks, and k-anonymity suppression, all without
a second pass over the data (DESIGN.md §16).

    PYTHONPATH=src python examples/torch_analytics_geo.py           # cuda
    PYTHONPATH=src python examples/torch_analytics_geo.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.analytics import AnalyticsConfig, BlockAggregator
from repro_torch.core.engine import GeoEngine
from repro_torch.core.synth import build_synth_census
from repro_torch.serving import GeoServer, ServeConfig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seconds", type=int, default=16,
                    help="simulated seconds of traffic")
    args = ap.parse_args(argv)
    # 1. A census and an engine, as ever; the analytics mount is one
    #    config field.  window_s=8/slide_s=2 → sliding windows of 4
    #    panes; k_anon=5 suppresses any block seen by <5 distinct
    #    sources; the injected clock makes the demo deterministic.
    print("building synthetic census...")
    sc = build_synth_census(seed=3, n_states=8, counties_per_state=6,
                            blocks_per_county=16)
    engine = GeoEngine.build(sc.census, "fast", device=args.device)
    now = [0.0]
    server = GeoServer(engine, ServeConfig(
        buckets=(1024, 4096),
        analytics=AnalyticsConfig(window_s=8.0, slide_s=2.0, k_anon=5,
                                  sketch_bits=2048,
                                  clock=lambda: now[0])))
    server.warm()

    # 2. Traffic with structure: a background of uniform points plus a
    #    "venue" hotspot — one block that 40% of sources flock to.
    rng = np.random.default_rng(11)
    xy, bid, *_ = sc.sample_points(rng, 40_000)
    venue_block = int(np.bincount(bid[bid >= 0]).argmax())
    venue_pts = xy[bid == venue_block]
    print(f"venue block: {venue_block} ({len(venue_pts)} sampled pts)")

    off = 0
    stream = []
    for second in range(args.seconds):
        now[0] = float(second)
        req = xy[off:off + 2048]
        off += len(req)
        if len(venue_pts) and second >= 4:   # the crowd arrives at t=4
            extra = venue_pts[rng.integers(0, len(venue_pts), 1024)]
            req = np.concatenate([req, extra])
        stream.append(req)
        server.submit(req)
    now[0] = 2.0 * args.seconds       # push the watermark: one trailing
    server.submit(xy[:1])             # batch closes every open window

    # 3. The analytics snapshot: per-region window history.  Each
    #    finalized window publishes suppression-filtered top-k rows —
    #    blocks under the k_anon floor are counted but never named.
    snap = server.snapshot_analytics()
    region = snap["regions"][0]
    print(f"\nobserved {region['observed']} points "
          f"({region['off_map']} off-map), "
          f"{region['finalized_total']} windows finalized")
    for w in region["finalized"][-4:]:
        top = ", ".join(f"block {r['block']}: {r['count']}"
                        f" ({r['distinct']} sources)"
                        for r in w["top"][:3])
        print(f"  [{w['start']:5.1f}, {w['end']:5.1f})  "
              f"{w['n_events']:6d} events  "
              f"{w['active_blocks']:4d} active  "
              f"{w['suppressed_blocks']:4d} suppressed  top: {top}")

    # 4. The batch layer under the same roof: one fused assign→aggregate
    #    call gives whole-stream occupancy, density, and an HVI-style
    #    composite (z-scored density + occupancy, 60/40 blend).
    agg = BlockAggregator.from_engine(engine)
    counts = agg.fused_counts(np.concatenate(stream))
    density = agg.density(counts)
    hvi = agg.weighted_index(
        np.stack([density, counts.astype(np.float64)], axis=1),
        [0.6, 0.4])
    top = np.argsort(-hvi)[:5]
    print("\nwhole-stream composite index (density 0.6 / occupancy 0.4):")
    for b in top:
        print(f"  block {int(b):5d}  count {int(counts[b]):5d}  "
              f"density {density[b]:9.1f}  index {hvi[b]:6.2f}")
    assert int(top[0]) == venue_block or counts[top[0]] >= counts.max()
    return {"venue": venue_block, "top": top, "counts": counts,
            "snapshot": snap}


if __name__ == "__main__":
    main()

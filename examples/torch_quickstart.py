"""Quickstart on the PyTorch + CUDA port: map locations onto census
blocks with every GeoEngine strategy — the paper's simple (§III) and
fast (§IV) approaches plus the engine's hybrid mode.

    PYTHONPATH=src python examples/torch_quickstart.py               # cuda
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

On ``cuda`` every strategy runs the hand-written CUDA kernels (built
with nvcc at first use); ``--device cpu`` runs their plain PyTorch twins.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core.engine import EngineConfig, GeoEngine
from repro_torch.core.synth import build_synth_census


def timed_assign(engine, pts):
    def sync():
        if engine.device.type == "cuda":
            torch.cuda.synchronize(engine.device)

    res = engine.assign(pts)                  # warm up: kernel build
    sync()
    t0 = time.perf_counter()
    res = engine.assign(pts)
    sync()
    return res, time.perf_counter() - t0


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--points", type=int, default=100_000)
    args = ap.parse_args()
    # 1. A synthetic census: 16 states / 128 counties / 3,072 block groups
    #    (same structure as the real data; see core/synth.py).
    print("building synthetic census...")
    sc = build_synth_census(seed=0, n_states=16, counties_per_state=8,
                            blocks_per_county=24)
    census = sc.census
    print(f"  states={census.states.n_poly} counties={census.counties.n_poly}"
          f" blocks={census.blocks.n_poly}")

    # 2. A batch of device locations with known ground truth.
    rng = np.random.default_rng(7)
    xy, bid, cid, sid = sc.sample_points(rng, args.points)
    pts = torch.from_numpy(xy).to(args.device)

    # 3. One facade, four strategy/mode combinations.  The covering is
    #    built once and shared by the cell-index strategies.
    print("building cell covering...")
    covering = None
    for label, strategy, cfg in (
        ("simple      ", "simple",
         EngineConfig(cap_state=0.5, cap_county=0.5, cap_block=0.5)),
        ("fast (exact)", "fast", EngineConfig(mode="exact",
                                              cap_boundary=0.5)),
        ("fast (approx)", "fast", EngineConfig(mode="approx")),
        ("hybrid      ", "hybrid", EngineConfig(cap_boundary=0.5)),
    ):
        engine = GeoEngine.build(census, strategy, cfg, covering=covering,
                                 device=args.device)
        covering = covering or engine.covering
        res, dt = timed_assign(engine, pts)
        acc = float(np.mean(res.block.cpu().numpy() == bid))
        print(f"{label}: {len(xy)/dt/1e6:5.2f}M pts/s, accuracy {acc:.4f},"
              f" {int(res.stats.n_pip)/len(xy):.3f} PIP evals/pt,"
              f" overflow {int(res.stats.overflow)}")

    # 4. Or skip the choice entirely: strategy="auto" asks the planner
    #    (device kind, measured boundary fraction, index capabilities)
    #    and explain() says what it chose and why.
    engine = GeoEngine.build(census, "auto", covering=covering,
                             device=args.device)
    plan = engine.explain()
    res, dt = timed_assign(engine, pts)
    acc = float(np.mean(res.block.cpu().numpy() == bid))
    print(f"auto -> {plan['strategy']:7s}: {len(xy)/dt/1e6:5.2f}M pts/s, "
          f"accuracy {acc:.4f}")
    for reason in plan["reasons"]:
        print(f"  because: {reason}")


if __name__ == "__main__":
    main()

"""Distributed geo join on the PyTorch + CUDA port (twin of
examples/distributed_geo_join.py), two flavours over a mesh of ranks:

  * replicated-points lookup (core/distributed.py): every model rank
    scans its data rank's share of the batch against its Morton slice,
    an i32 pmax combines;
  * dispatch-routed lookup (GeoEngine.assign_sharded): points are
    bucketed by owning shard through the MoE dispatch primitive, so each
    rank resolves only the ~N/S points it owns (DESIGN.md §2, §6).

    PYTHONPATH=src python examples/torch_distributed_geo_join.py
        # one NCCL rank per visible GPU, on the card
    PYTHONPATH=src python examples/torch_distributed_geo_join.py \\
        --device cpu --backend gloo --ranks 8
        # the JAX example's (2, 4) mesh as 8 CPU processes

R ranks form a ("data", "model") mesh of (R / 4, 4) when 4 divides R,
else (1, R).  The launcher builds the census and its covering once and
hands them to the ranks as a saved ``GeoIndexSet``; the ranks meet on a
``tcp://127.0.0.1`` port.
"""
import argparse
import os
import socket
import tempfile
import time
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core.artifact import GeoIndexSet
from repro_torch.core.distributed import assign_fast_distributed
from repro_torch.core.engine import EngineConfig, GeoEngine
from repro_torch.core.fast import FastConfig
from repro_torch.core.synth import build_synth_census
from repro_torch.launch.mesh import make_mesh

SCALE = dict(seed=0, n_states=16, counties_per_state=8, blocks_per_county=24)
MAX_LEVEL = 9


def mesh_shape(ranks: int) -> tuple:
    model = 4 if ranks % 4 == 0 else ranks
    return ranks // model, model


def rank_main(rank, args, addr, artifact, data):
    device = (f"cuda:{rank % torch.cuda.device_count()}"
              if args.device == "cuda" else "cpu")
    if args.device == "cuda":
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(max(1, os.cpu_count() // args.ranks))
    # A rank that stops answering fails the others within two minutes.
    dist.init_process_group(args.backend, init_method=addr, rank=rank,
                            world_size=args.ranks,
                            timeout=timedelta(minutes=2))
    try:
        lead = rank == 0
        mesh = make_mesh(mesh_shape(args.ranks), ("data", "model"))
        idx = GeoIndexSet.load(artifact, device=device)
        with np.load(data) as z:
            xy, bid = z["xy"], z["bid"]
        pts = torch.from_numpy(xy).to(device)
        sidx = idx.sharded_index(mesh.shape["model"])
        if lead:
            print(f"[dist] {len(idx.covering.lo)} cells -> "
                  f"{sidx.n_shards} Morton shards, "
                  f"{sidx.index_bytes_per_shard() / 1e6:.2f} MB/shard (vs "
                  f"{idx.covering.nbytes() / 1e6:.2f} MB replicated); mesh "
                  f"{mesh.shape} over {args.backend} on {device}")

        def timed(fn):
            fn()                                   # warm-up
            if device != "cpu":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            if device != "cpu":
                torch.cuda.synchronize()
            return out, time.perf_counter() - t0

        cfg = FastConfig(mode="exact", cap_boundary=0.5)
        (_, _, b, stats), dt = timed(
            lambda: assign_fast_distributed(sidx, pts, mesh, cfg))
        acc = float(np.mean(b.cpu().numpy() == bid))
        if lead:
            print(f"[dist] {len(xy) / dt / 1e6:.2f}M pts/s on {mesh.size} "
                  f"ranks, accuracy {acc:.4f}, PIP evals/pt "
                  f"{int(stats['n_pip']) / len(xy):.3f}")
        assert acc == 1.0, f"rank {rank}: accuracy {acc}"

        # Same lookup through the engine facade, dispatch-routed: each
        # shard receives only its own points (capacity-bucketed, drops
        # counted).
        engine = GeoEngine.from_index_set(
            idx, "fast", EngineConfig(mode="exact", cap_boundary=0.5))
        res, dt = timed(lambda: engine.assign_sharded(pts, mesh))
        acc = float(np.mean(res.block.cpu().numpy() == bid))
        if lead:
            print(f"[engine] {len(xy) / dt / 1e6:.2f}M pts/s "
                  f"dispatch-routed, accuracy {acc:.4f}, dropped "
                  f"{int(res.stats.extra['n_dropped'])}; collectives "
                  f"{mesh.route}")
        assert acc == 1.0, f"rank {rank}: accuracy {acc}"
    finally:
        dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    ap.add_argument("--ranks", type=int,
                    help="processes (default: one a visible GPU)")
    ap.add_argument("--points", type=int, default=65536)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu --backend gloo "
                         "to run the ranks on the CPU")
    if args.ranks is None:
        args.ranks = torch.cuda.device_count() if args.device == "cuda" \
            else 8
    sc = build_synth_census(**SCALE)
    idx = GeoIndexSet.build(sc.census, ("covering",), max_level=MAX_LEVEL,
                            device="cpu")
    xy, bid, *_ = sc.sample_points(np.random.default_rng(7), args.points)
    with socket.socket() as s:              # a free port for the rendezvous
        s.bind(("127.0.0.1", 0))
        addr = f"tcp://127.0.0.1:{s.getsockname()[1]}"
    with tempfile.TemporaryDirectory() as tmp:
        artifact, data = idx.save(os.path.join(tmp, "map")), \
            os.path.join(tmp, "points.npz")
        np.savez(data, xy=xy, bid=bid)
        mp.spawn(rank_main, args=(args, addr, artifact, data),
                 nprocs=args.ranks)


if __name__ == "__main__":
    main()

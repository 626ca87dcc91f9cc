"""Shared harness of tests/test_torch_sharded.py (no test file): the
sharded-lookup cases both packages run on a mesh, the JAX package's run
of them on fake devices (jitted, in a child interpreter), the port's run
on gloo CPU ranks, and the spawn that runs those ranks under a time limit.

Both sides write {"{mesh}/{case}/{field}": array} to an npz: the state,
county and block ids, and the stats as a JSON string.  Only numpy is
imported at the top: the JAX child imports this module too.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np

# tests/test_engine.py's EXACT_CFG, less its backend.
BASE = dict(cap_state=1.0, cap_county=1.0, cap_block=1.0, cap_boundary=1.0,
            max_level=8)
# case -> (EngineConfig changes, batch).  "drop" sends 3/4 of its batch
# into one Morton shard with a capacity of N/8 a shard; "empty" sends all
# of it into one shard (capacity N: nothing dropped, three shards empty).
SHARDED_CASES = {
    "exact": ({}, "points"),
    "exact_fused": ({"fused": True}, "points"),
    "approx": ({"mode": "approx"}, "points"),
    "drop": ({"cap_shard": 0.5}, "skewed"),
    "empty": ({"cap_shard": 4.0}, "one_range"),
}
# assign_fast_distributed: case -> (FastConfig changes, batch).
DIST_CASES = {
    "dist": ({}, "points"),
    "dist_fused": ({"fused": True}, "points"),
}
DIST_CAP = 0.5
MESHES = {4: ((1, 4),), 8: ((2, 4),)}
XLA_FLAGS = "--xla_force_host_platform_device_count=8"
RANK_TIMEOUT_S = 120


def mesh_tag(shape) -> str:
    return "x".join(str(s) for s in shape)


def record(out: dict, key: str, sid, cid, bid, stats: dict) -> None:
    for field, ids in zip(("state", "county", "block"), (sid, cid, bid)):
        out[f"{key}/{field}"] = np.asarray(ids)
    out[f"{key}/stats"] = np.array(json.dumps(
        {k: int(v) for k, v in stats.items()}, sort_keys=True))


def jax_reference(artifact: str, batches: str, out_file: str) -> None:
    """Every case on meshes (1, 4) and (2, 4) through ``repro`` with
    backend "ref", jitted; each sharded index is built eagerly first (a
    first build inside a trace would cache a tracer in the artifact)."""
    import jax
    import jax.numpy as jnp

    from repro.core.artifact import GeoIndexSet
    from repro.core.distributed import assign_fast_distributed
    from repro.core.engine import EngineConfig, GeoEngine
    from repro.core.fast import FastConfig
    from repro.launch.mesh import make_test_mesh, use_mesh

    assert jax.device_count() == 8, jax.devices()
    idx = GeoIndexSet.load(artifact)
    data = dict(np.load(batches))
    out = {}
    for shape in (s for shapes in MESHES.values() for s in shapes):
        mesh = make_test_mesh(shape)
        n_shards = shape[-1]
        for name, (kw, batch) in SHARDED_CASES.items():
            cfg = EngineConfig(backend="ref", **BASE, **kw)
            eng = GeoEngine.from_index_set(idx, "fast", cfg)
            idx.sharded_index(n_shards, with_pool=bool(cfg.fused)
                              and cfg.mode == "exact")
            with use_mesh(mesh):
                res = jax.jit(lambda p: eng.assign_sharded(p, mesh))(
                    jnp.asarray(data[batch]))
            record(out, f"{mesh_tag(shape)}/{name}", res.state, res.county,
                   res.block, res.stats.as_dict())
        for name, (kw, batch) in DIST_CASES.items():
            fcfg = FastConfig(mode="exact", cap_boundary=DIST_CAP,
                              backend="ref", **kw)
            sidx = idx.sharded_index(n_shards, with_pool=bool(fcfg.fused))
            with use_mesh(mesh):
                sid, cid, bid, st = jax.jit(
                    lambda p: assign_fast_distributed(sidx, p, mesh, fcfg))(
                    jnp.asarray(data[batch]))
            record(out, f"{mesh_tag(shape)}/{name}", sid, cid, bid, st)
    np.savez(out_file, **out)
    print("jax reference done")


def torch_rank(rank: int, world: int, init_file: str, artifact: str,
               batches: str, out_dir: str) -> None:
    """One gloo CPU rank of the port: every case on this world's meshes,
    written to ``out_dir/rank{rank}.npz`` with the rank's coordinates."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    from repro_torch.core.artifact import GeoIndexSet
    from repro_torch.core.distributed import assign_fast_distributed
    from repro_torch.core.engine import EngineConfig, GeoEngine
    from repro_torch.core.fast import FastConfig
    from repro_torch.launch.mesh import make_test_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=RANK_TIMEOUT_S))
    try:
        idx = GeoIndexSet.load(artifact, device="cpu")
        data = {k: torch.from_numpy(v) for k, v in np.load(batches).items()}
        out = {}
        for shape in MESHES[world]:
            mesh = make_test_mesh(shape)
            tag = mesh_tag(shape)
            out[f"{tag}/coords"] = np.array(
                [mesh.coords[a] for a in mesh.axis_names])
            for name, (kw, batch) in SHARDED_CASES.items():
                eng = GeoEngine.from_index_set(
                    idx, "fast", EngineConfig(**BASE, **kw))
                res = eng.assign_sharded(data[batch], mesh)
                record(out, f"{tag}/{name}", res.state, res.county,
                       res.block, res.stats.as_dict())
            for name, (kw, batch) in DIST_CASES.items():
                fcfg = FastConfig(mode="exact", cap_boundary=DIST_CAP, **kw)
                sidx = idx.sharded_index(shape[-1],
                                         with_pool=bool(fcfg.fused))
                sid, cid, bid, st = assign_fast_distributed(
                    sidx, data[batch], mesh, fcfg)
                record(out, f"{tag}/{name}", sid, cid, bid, st)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def spawn_ranks(world: int, args: tuple, timeout: float,
                target=None) -> None:
    """Run ``target(rank, world, *args)`` (default ``torch_rank``) on
    ``world`` spawned processes; raise if one fails or they do not all
    finish within ``timeout`` seconds (a rank stuck in a collective is
    terminated, never waited on)."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    target = target or torch_rank
    procs = [ctx.Process(target=target, args=(r, world, *args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    stuck = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    if stuck:
        raise RuntimeError(f"gloo ranks {stuck} of {world} did not finish "
                           f"within {timeout} s")
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise RuntimeError(f"gloo ranks of {world} exited with {codes}")

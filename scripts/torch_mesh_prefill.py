"""A model's prefill at its published widths on a ("data", "model") mesh
(or, given one extent, a ("data",) mesh), one NCCL rank a GPU: the
multi-card record of PERF.md.

  python3 scripts/torch_mesh_prefill.py --layers 32 --mesh 1 4
  python3 scripts/torch_mesh_prefill.py --arch llama-3.2-vision-90b \
      --mesh 1 4
  python3 scripts/torch_mesh_prefill.py --arch deepseek-v2-236b \
      --layers 20 --mesh 1 4
  python3 scripts/torch_mesh_prefill.py --tree blocks --mesh 2 2
  python3 scripts/torch_mesh_prefill.py --arch llama-3.2-vision-90b \
      --tree blocks --mesh 2 2
  python3 scripts/torch_mesh_prefill.py --tree blocks --mesh 4

``--arch`` is Mixtral-8x7B (the default), Llama-3.2-Vision-90B or
DeepSeek-V2-236B.  Each rank draws its own blocks of random weights
(each split leaf's block from a seed and the rank: no single process
could hold any of them, 93 GB, 179 GB and, at 20 of DeepSeek-V2's 60
layers, 157 GB in bf16; a leaf every rank holds whole from one seed
alike on every rank, so that on a ("data",) mesh every rank routes the
gathered batch as one router) and runs ``make_prefill_step`` over
the arch's BATCHES x SEQ tokens.  ``--tree whole`` (the default) gathers
the rank's compute tree once, every leaf at once
(``runtime.steps.compute_params``: MLA's re-blocked ``wuq`` gathered and
cut to the rank's heads), and hands it to each forward; ``--tree
blocks`` hands each forward the rank's blocks, and the step gathers what
it reads inside the forward (a block at a time, the leaves outside the
stacks once a forward), so each timed forward includes its gathers.  The
forward runs tensor-parallel over "model" (each rank its heads,
FFN and vocab blocks, the experts, DeepSeek-V2's shared experts' width;
flash at [B_loc * H / m, S, hd], none for MLA's head dim of 192).  On a
("data",) mesh each rank runs the experts on its slice of one global
capacity plan's slots (``models.moe``), every weight gathered whole.  The
vlm's gates, which start at zero and would hide the image path, are
drawn from U(0.5, 1.5) and its N_IMG x d_vision image tokens a row from
normals, both from SEED alike on every rank.  Printed:
the median host milliseconds of REPS forwards after a warm-up (each
ending in a sync), tok/s, the kernel launches of one forward by route,
the MoE layers' dropped (token, choice) pairs of that forward, its
collectives' calls and result bytes by kind
(``launch.dryrun.counted_collectives``; the residual is
sequence-parallel at SEQ in every arch here), peak device memory, the
gather's seconds (``--tree whole``) and the collectives' routes, per
rank.  Rank 0 prints them, with the card's name and power limit, as one
JSON line and writes ``--out``.  A rank that runs out of device memory
reports it as its result (``error``, the peak and the step it reached)
and the script exits 1.
"""
import argparse
import dataclasses
import gc
import json
import os
import socket
import subprocess
import sys
import time
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

BATCHES = {"mixtral-8x7b": 8, "llama-3.2-vision-90b": 4,
           "deepseek-v2-236b": 4}
SEQ, REPS, SEED = 2048, 3, 0


def mesh_axes(shape) -> tuple:
    """The axis names of a mesh of ``shape``: ("data",) for one extent,
    ("data", "model") for two."""
    return ("data", "model")[:len(shape)]


def random_blocks(model, shardings, seed: int, device,
                  whole_seed: int) -> dict:
    """{parameter name: this rank's block}, each drawn with the
    initializer of its spec at the block's shape (scaled by the spec's
    fan-in): a split leaf's from one generator seeded by ``seed``, a
    whole leaf's from one seeded by ``whole_seed``."""
    from repro_torch.models.module import _init_one, _per_layer, flatten
    from repro_torch.sharding.rules import local_shard
    gens = {False: torch.Generator(device=device).manual_seed(seed),
            True: torch.Generator(device=device).manual_seed(whole_seed)}
    dtypes = {k: p.dtype for k, p in model.named_parameters()}
    out = {}
    for name, spec in flatten(model.specs).items():
        meta = torch.empty(spec.shape, device="meta")
        for pname, part in _per_layer(name, meta, model):
            sh = shardings[pname]
            shape = tuple(local_shard(part, sh.spec, sh.mesh).shape)
            fan = spec.fan_in or (spec.shape[-2] if len(spec.shape) >= 2
                                  else spec.shape[-1])
            out[pname] = _init_one(dataclasses.replace(
                spec, shape=shape, axes=(None,) * len(shape), fan_in=fan),
                gens[shape == tuple(part.shape)], device).to(dtypes[pname])
    return out


def vlm_inputs(model, params, batch: int, device) -> torch.Tensor:
    """The vlm's gates drawn live into ``params`` and its image tokens
    [batch, n_img, d_vision] (bf16), both from SEED, alike on every
    rank."""
    cfg = model.cfg
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    with torch.no_grad():
        for g in range(len(model.groups)):
            for leaf in ("gate", "ffn_gate"):
                params[f"groups.{g}.cross.{leaf}"].uniform_(0.5, 1.5,
                                                            generator=gen)
    return torch.randn((batch, cfg.n_img_tokens, cfg.d_vision),
                       generator=gen, device=device).to(torch.bfloat16)


def rank_main(rank, args, addr, out_file):
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import build_model
    from repro_torch.runtime import steps
    from repro_torch.sharding.rules import model_shardings
    world = int(np.prod(args.mesh))
    device = f"cuda:{rank}"
    torch.cuda.set_device(device)
    dist.init_process_group("nccl", init_method=addr, rank=rank,
                            world_size=world,
                            timeout=timedelta(minutes=5))
    try:
        cfg = get_config(args.arch)
        cfg = dataclasses.replace(cfg, n_layers=args.layers or cfg.n_layers)
        batch = BATCHES[args.arch]
        mesh = make_mesh(tuple(args.mesh), mesh_axes(args.mesh))
        model = build_model(cfg, "meta")
        t0 = time.perf_counter()
        params = random_blocks(model, model_shardings(model, mesh),
                               SEED * 1000 + rank, device,
                               SEED * 1000 + world)
        block_bytes = sum(p.numel() * p.element_size()
                          for p in params.values())
        torch.cuda.synchronize()
        draw_s = time.perf_counter() - t0
        run = serve_mod.run_config(SEQ)
        step = steps.make_prefill_step(model, run, mesh)
        inputs = {"tokens": serve_mod.make_prompts(cfg, batch, SEQ, SEED,
                                                   device)}
        if cfg.family == "vlm":
            inputs["img"] = vlm_inputs(model, params, batch, device)
        rec = dict(rank=rank, coords=mesh.coords, tree=args.tree,
                   block_bytes=block_bytes, draw_s=draw_s)
        try:
            measure(args, cfg, model, mesh, step, params, inputs, batch, rec)
        except torch.cuda.OutOfMemoryError as e:
            rec.update(error=f"OutOfMemoryError: {str(e).splitlines()[0]}",
                       peak_bytes=torch.cuda.max_memory_allocated())
        if "error" in rec:
            # NCCL allocates outside PyTorch's cache: hand back what the
            # failed step held before the ranks exchange their records.
            gc.collect()
            torch.cuda.empty_cache()
        recs = [None] * world
        dist.all_gather_object(recs, rec)
        if rank == 0:
            card = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True,
                text=True).stdout.strip().splitlines()
            summary = dict(arch=cfg.name, layers=cfg.n_layers,
                           params=model.param_count(), mesh=args.mesh,
                           tree=args.tree, backend="nccl", batch=batch,
                           seq=SEQ, cards=card, ranks=recs)
            print(json.dumps(summary))
            if out_file:
                with open(out_file, "w") as f:
                    json.dump(summary, f, indent=1)
        if any("error" in r for r in recs):
            raise SystemExit(1)
    finally:
        dist.destroy_process_group()


def measure(args, cfg, model, mesh, step, params, inputs, batch,
            out: dict) -> None:
    """One rank's record, into ``out``: the tree's gather (``--tree
    whole``), a warm-up forward, one counted forward, REPS timed ones;
    ``stage`` says how far it got while it runs (where device memory
    runs out, it stays)."""
    from repro_torch.kernels import _build
    from repro_torch.launch import dryrun
    from repro_torch.models import transformer as tf
    from repro_torch.runtime import steps
    out["stage"] = "gather"
    torch.cuda.reset_peak_memory_stats()
    gather_s, tree = None, params
    if args.tree == "whole":
        t0 = time.perf_counter()
        tree = steps.compute_params(model, params, mesh)
        torch.cuda.synchronize()
        gather_s = time.perf_counter() - t0
    out["stage"] = "warm-up"
    step(tree, inputs)
    torch.cuda.synchronize()
    out["stage"] = "counted forward"
    _build.reset_launches()
    dropped, real = [], tf.moe_ffn

    def moe_ffn(*a, **kw):
        y, aux = real(*a, **kw)
        dropped.append(int(aux["dropped"]))
        return y, aux
    tf.moe_ffn = moe_ffn
    try:
        with dryrun.counted_collectives() as tally:
            last = step(tree, inputs)
            torch.cuda.synchronize()
    finally:
        tf.moe_ffn = real
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    routes = {k: v for k, v in _build.ROUTE_LAUNCHES.items() if v}
    if not bool(torch.isfinite(last).all()):
        raise RuntimeError("prefill logits not finite")
    out["stage"] = "timed forwards"
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(tree, inputs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    ms = float(np.median(times)) * 1e3
    del out["stage"]
    out.update(ms=ms, ms_all=[t * 1e3 for t in times],
               tok_s=batch * SEQ / (ms / 1e3),
               launches=launches, launch_routes=routes,
               flash_shape=[batch // args.mesh[0] * cfg.n_heads
                            // args.mesh[-1] ** (len(args.mesh) - 1),
                            SEQ, cfg.hd]
               if launches else None,
               dropped=sum(dropped), moe_layers=len(dropped),
               collective_calls=dict(tally.counts),
               collective_bytes=dict(tally.bytes),
               peak_bytes=torch.cuda.max_memory_allocated(),
               gather_s=gather_s, routes=dict(mesh.routes))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mixtral-8x7b", choices=sorted(BATCHES))
    ap.add_argument("--layers", type=int, default=0,
                    help="layers (default: the config's)")
    ap.add_argument("--mesh", type=int, nargs="+", default=[1, 4],
                    help="data extent, or data and model extents")
    ap.add_argument("--tree", default="whole", choices=("whole", "blocks"),
                    help="hand each forward the compute tree gathered "
                    "once (whole) or the rank's blocks (blocks)")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if len(args.mesh) not in (1, 2):
        ap.error("--mesh takes one extent or two")
    world = int(np.prod(args.mesh))
    if torch.cuda.device_count() < world:
        raise SystemExit(f"a {args.mesh} mesh needs {world} GPUs, "
                         f"{torch.cuda.device_count()} visible")
    with socket.socket() as s:              # a free port for the rendezvous
        s.bind(("127.0.0.1", 0))
        addr = f"tcp://127.0.0.1:{s.getsockname()[1]}"
    mp.spawn(rank_main, args=(args, addr, args.out), nprocs=world)


if __name__ == "__main__":
    main()

"""Dry-run of every (architecture x input shape x mesh) cell on the meta
device (port of src/repro/launch/dryrun.py): no weight is ever allocated.

``repro`` lowers and compiles each cell on 512 placeholder devices from
``ShapeDtypeStruct`` stand-ins.  The port has no compiler to ask, so it
runs the real step of one representative rank on "meta" tensors (shapes
and dtypes, no memory), which is what the tool is, not a CPU fallback:
it needs no card and allocates nothing on any device.  The rank's
inputs come from the helpers the sharded steps use: its parameter blocks
(``sharding.rules.model_shardings`` / ``local_shard`` of the template's
parameters), AdamW's state of those blocks, the cell's global batch
(``models.model.input_specs``; the step takes its rows) and its block of
the cache (``runtime.steps.local_cache``).  Then
``make_train_step`` / ``make_prefill_step`` / ``make_serve_step`` run on
them over a ``CountingMesh``: ``launch.mesh.Mesh`` with no process
group, whose collectives return meta tensors of their results' shapes
and count them.  ``sharding.rules.shard_slices`` only splits dimensions
that divide, so every rank's blocks have the same shapes; rank 0 stands
for all (a test holds the last rank's record equal).

For each cell it records, per rank:

  * ``flops_per_device``: ``torch.utils.flop_counter.FlopCounterMode``'s
    total over the step (forward, backward and remat recomputation).  On
    meta the kernel wrappers take their plain twins (``"route": "ref"``),
    so attention counts the twin's products, as ``repro``'s CPU lowering
    counts ``blockwise_attn``'s dots;
  * ``bytes_accessed_per_device``: ``repro``'s rule
    (``launch/hlo_cost.py``): 2 x the result bytes of every op whose
    result is at least 1 MiB; a result that is a view of an input counts
    0, one written in place counts its bytes.  Eager ops are not fused,
    so this is at least what XLA's fused program moves;
  * ``collective_bytes_per_device`` / ``collective_counts``: the result
    bytes and the number of the collectives the step calls, by kind under
    HLO's names (all-reduce, all-gather, reduce-scatter), each autograd
    backward's included.  This is NCCL's route, one call a collective:
    gloo's host or ``psum`` staging of a CUDA buffer (``Mesh.routes``) is
    not counted;
  * ``memory``: ``argument_size``, the bytes of the step's inputs on this
    rank (its blocks, moments, batch rows, cache); ``output_size``, those
    of its outputs that alias no input; ``temp_size``, the peak of the
    bytes live above the arguments during the step (every storage an op
    makes, counted until it is freed; outputs included while live).  The
    caching allocator's rounding is not modelled;
  * ``block_bytes``: the bytes of this rank's parameter blocks, beside
    ``params`` / ``param_bytes``, the whole model's count and bytes;
    ``tree_bytes``: the most bytes of the compute tree the forward reads
    that the step holds at once (``runtime.steps.PerBlock``: the leaves
    outside the stacks, gathered once a step, and the largest stacked
    block's gathered leaves), and ``whole_tree_bytes`` the whole tree's,
    every leaf gathered at once (what ``compute_params`` holds, and every
    step held before it gathered block by block).

The steps gather each stacked block's leaves just before the block runs
and free them after it, so ``temp_size`` holds one block's gathered
leaves where the whole tree's used to sit: it is lower by about
``whole_tree_bytes`` less ``tree_bytes`` (less where leaves of the whole
tree are the rank's blocks themselves, as the experts are), and FLOPs
do not move.  A train step under remat "full" (or "dots") gathers each
block's leaves twice, in the forward and again in the backward's
recompute: the block leaves' all-gather calls and bytes double, their
gradients' reduce-scatters do not.  A block that is not rematerialized
(remat "none"; the vlm's cross blocks, zamba2's LoRA, the sLSTM)
gathers a leaf again for each tensor its backward reads of it.

``xla_cost_analysis`` and ``generated_code_size`` have no counterpart;
``lower_s`` / ``compile_s`` are ``trace_s``.

Usage:
  python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod-only |
      --single-pod-only]
  python -m repro_torch.launch.dryrun --all --out results/dryrun_torch.json
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import threading
import time
import traceback
import weakref
from typing import Dict, Sequence

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig, \
    shapes_for
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models.model import Model, build_model, input_specs
from repro_torch.models.module import param_bytes, param_count
from repro_torch.optim import adamw
from repro_torch.runtime import steps
from repro_torch.sharding.rules import batch_axes, local_shard, \
    model_shardings, split_batch, tp_leaves, tp_pieces

META = torch.device("meta")
KINDS = ("all-reduce", "all-gather", "reduce-scatter")
MIN_TRAFFIC_BYTES = 1 << 20     # repro's rule: 1 MiB


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Collectives:
    """Result bytes and calls of each collective kind."""

    def __init__(self):
        self.bytes: Dict[str, int] = dict.fromkeys(KINDS, 0)
        self.counts: Dict[str, int] = dict.fromkeys(KINDS, 0)

    def add(self, kind: str, out: torch.Tensor) -> None:
        self.bytes[kind] += nbytes(out)
        self.counts[kind] += 1


class CountingMesh(Mesh):
    """``Mesh``'s interface at ``rank`` with no process group: each
    collective over axes longer than 1 returns an uninitialized tensor of
    its result's shape on its input's device, and is counted in
    ``tally`` (shared with every ``with_batch`` view)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 rank: int = 0):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} and axes "
                             f"{tuple(axis_names)} differ in length")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.size = math.prod(self.shape.values())
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} of a mesh of {self.size}")
        self.rank = rank
        dims = tuple(self.shape.values())
        self.coords = dict(zip(self.axis_names, (
            int(c) for c in np.unravel_index(rank, dims))))
        self.batch_axes = ()
        self.routes = {"all_reduce": "direct", "all_gather": "direct",
                       "reduce_scatter": "direct"}
        self._groups = {}
        self.tally = Collectives()

    def _all_reduce(self, x, axes, op):
        if not self._key(axes):
            return x
        out = x.new_empty(x.shape)
        self.tally.add("all-reduce", out)
        return out

    def all_gather(self, x, axes, dim: int = 0):
        key = self._key(axes)
        if not key:
            return x
        shape = list(x.shape)
        shape[dim] *= self.axis_size(key)
        out = x.new_empty(shape)
        self.tally.add("all-gather", out)
        return out

    def psum_scatter(self, x, axes, dim: int = 0):
        key = self._key(axes)
        if not key:
            return x
        n = self.axis_size(key)
        if x.shape[dim] % n:
            raise ValueError(f"psum_scatter: dimension {dim} of "
                             f"{tuple(x.shape)} over {n} ranks")
        shape = list(x.shape)
        shape[dim] //= n
        out = x.new_empty(shape)
        self.tally.add("reduce-scatter", out)
        return out


@contextlib.contextmanager
def counted_collectives():
    """Every ``launch.mesh.Mesh`` of this process counts the collectives
    it is called for inside the block, by ``CountingMesh``'s rule, into
    the ``Collectives`` yielded: a call that runs on through another
    (``all_gather`` / ``psum_scatter`` over ``psum``, gloo's route for a
    CUDA buffer) counts once, as the outer kind."""
    tally, depth = Collectives(), [0]
    kinds = {"_all_reduce": "all-reduce", "all_gather": "all-gather",
             "psum_scatter": "reduce-scatter"}
    real = {name: Mesh.__dict__[name] for name in kinds}

    def wrap(name):
        fn, kind = real[name], kinds[name]

        def call(self, x, axes, *args, **kwargs):
            depth[0] += 1
            try:
                out = fn(self, x, axes, *args, **kwargs)
            finally:
                depth[0] -= 1
            if depth[0] == 0 and self._key(axes):
                tally.add(kind, out)
            return out
        return call
    for name in kinds:
        setattr(Mesh, name, wrap(name))
    try:
        yield tally
    finally:
        for name, fn in real.items():
            setattr(Mesh, name, fn)


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class StepTally(TorchDispatchMode):
    """The bytes ``repro``'s rule charges (``bytes``) and the peak of the
    bytes live in storages made inside the mode (``peak``; ``live`` now).
    A storage counts from the op that makes it until it is freed (a
    ``weakref.finalize`` on it); a result that shares an input's storage
    is a view (no bytes) unless the op writes it in place."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live = self.peak = 0
        self._sizes: Dict[int, int] = {}
        self._lock = threading.Lock()

    def _free(self, key: int) -> None:
        with self._lock:
            self.live -= self._sizes.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        seen = {_storage_key(t) for t in tree_leaves((args, kwargs))
                if isinstance(t, torch.Tensor)}
        writes = any(r.alias_info is not None and r.alias_info.is_write
                     for r in func._schema.returns)
        moved = 0
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            key = _storage_key(t)
            if key not in seen:
                moved += nbytes(t)
                self._track(t, key)
            elif writes:
                moved += nbytes(t)
        if moved >= MIN_TRAFFIC_BYTES:
            self.bytes += 2 * moved
        return out

    def _track(self, t: torch.Tensor, key: int) -> None:
        with self._lock:
            if key in self._sizes:
                return
            size = t.untyped_storage().nbytes()
            self._sizes[key] = size
            self.live += size
            self.peak = max(self.peak, self.live)
        weakref.finalize(t.untyped_storage(), self._free, key)


def tree_size(tree) -> int:
    """The bytes of ``tree``'s tensors, each tensor once (a view counts
    its own extent)."""
    return sum(nbytes(t) for t in _unique(tree))


def _unique(tree) -> list:
    out, seen = [], set()
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor) and id(t) not in seen:
            seen.add(id(t))
            out.append(t)
    return out


def rank_inputs(model: Model, shape: ShapeConfig, mesh) -> dict:
    """This rank's step inputs on meta: ``params`` (its blocks of the
    template's parameters, in their dtypes, with a gradient to train),
    ``opt`` (AdamW's state of them, train only), the global ``batch``
    and, for decode, ``tokens`` and its ``cache`` block."""
    train = shape.kind == "train"
    shardings = model_shardings(model, mesh)
    params = {}
    for name, p in model.named_parameters():
        block = local_shard(p, shardings[name].spec, mesh)
        params[name] = torch.empty(block.shape, dtype=p.dtype, device=META,
                                   requires_grad=train)
    out = {"params": params}
    specs = input_specs(model.cfg, shape, model=model)
    if shape.kind == "decode":
        out["tokens"] = specs["tokens"]
        out["cache"] = steps.local_cache(model, mesh, shape.global_batch,
                                         shape.seq_len, device=META)
    else:
        out["batch"] = specs
    if train:
        out["opt"] = adamw.init(params)
    return out


def _rows(mesh, inputs: dict) -> dict:
    """What of ``inputs`` this rank holds: the batch's and the tokens'
    rows, everything else as it is."""
    held = dict(inputs)
    for key in ("batch", "tokens"):
        if key in held:
            tree = held[key] if key == "batch" else {"t": held[key]}
            held[key] = split_batch(mesh, tree)[1]
    return held


def tree_bytes(model: Model, params: dict, mesh,
               shape: ShapeConfig) -> tuple:
    """(the most bytes of compute tree the step holds at once on this
    rank, the whole tree's bytes).  The whole tree is every leaf by the
    steps' rule (train: the bf16-cast blocks gathered over their axes;
    serving: the blocks gathered, uncast), built on a copy of ``mesh``
    whose collectives are counted apart; the step holds the leaves
    outside the stacks and one stacked block's at a time
    (``runtime.steps.PerBlock``), so at most those and the largest
    block's."""
    view = CountingMesh(tuple(mesh.shape.values()), mesh.axis_names,
                        mesh.rank)
    with torch.no_grad():
        if shape.kind == "train":
            p = {k: v.detach() for k, v in params.items()}
            tree = steps._compute_tree(
                steps.cast_params(p), model_shardings(model, view),
                batch_axes(view, shape.global_batch),
                tp_leaves(model, view), tp_pieces(model, view))
        else:
            tree = steps.compute_params(model, params, view)
    blocks = [[n for _, n in leaves]
              for leaves in steps.block_leaves(model).values()]
    inside = {n for names in blocks for n in names}
    most = tree_size({n: t for n, t in tree.items() if n not in inside}) \
        + max((tree_size({n: tree[n] for n in names}) for names in blocks),
              default=0)
    return most, tree_size(dict(tree))


def count_step(model: Model, shape: ShapeConfig, mesh: CountingMesh,
               run: RunConfig) -> dict:
    """The counts of one step of ``shape.kind`` on ``mesh``'s rank, its
    inputs built by ``rank_inputs`` from the template ``model`` (built
    on meta; ``trainable=True`` holds the specs' dtypes, ``repro``'s
    params; a serving build its dtypes by use)."""
    inputs = rank_inputs(model, shape, mesh)
    params = inputs["params"]
    argument = tree_size(_rows(mesh, inputs))
    tb, whole = tree_bytes(model, params, mesh, shape)
    # The step is built outside the count: its builder's stand-ins of the
    # stacked leaves (``model_shardings``) are bookkeeping, not the step's.
    if shape.kind == "train":
        step = steps.make_train_step(model, run, mesh)
        args = (params, inputs["opt"], inputs["batch"])
    elif shape.kind == "prefill":
        step = steps.make_prefill_step(model, run, mesh)
        args = (params, inputs["batch"])
    else:
        step = steps.make_serve_step(model, run, mesh)
        args = (params, inputs["tokens"], inputs["cache"])
    mesh.tally = Collectives()
    tally, flops = StepTally(), FlopCounterMode(display=False)
    t0 = time.monotonic()
    with flops, tally:
        out = step(*args)
    trace_s = time.monotonic() - t0
    held = {_storage_key(t) for t in tree_leaves(inputs)
            if isinstance(t, torch.Tensor)}
    output = sum(nbytes(t) for t in _unique(out)
                 if _storage_key(t) not in held)
    return {
        "flops_per_device": int(flops.get_total_flops()),
        "bytes_accessed_per_device": tally.bytes,
        "collective_bytes_per_device": dict(mesh.tally.bytes),
        "collective_counts": dict(mesh.tally.counts),
        "memory": {"argument_size": argument, "output_size": output,
                   "temp_size": tally.peak},
        "block_bytes": tree_size(params),
        "tree_bytes": tb,
        "whole_tree_bytes": whole,
        "trace_s": round(trace_s, 1),
    }


def counting_mesh(mesh) -> CountingMesh:
    """``mesh`` itself when it counts, else a ``CountingMesh`` of its
    shape at rank 0 (an ``AbstractMesh``, a ``Mesh``, anything with
    ``axis_names`` and a name -> size ``shape``)."""
    if isinstance(mesh, CountingMesh):
        return mesh
    return CountingMesh(tuple(mesh.shape[a] for a in mesh.axis_names),
                        mesh.axis_names)


def cell_record(cfg: ModelConfig, shape: ShapeConfig, mesh,
                run: RunConfig) -> dict:
    """``run_cell``'s record of ``cfg`` (any config, reduced or cut)."""
    cmesh = counting_mesh(mesh)
    model = build_model(cfg, META, trainable=True)
    rec = {
        "arch": cfg.name,
        "shape": shape.name,
        "kind": shape.kind,
        "mesh": dict(cmesh.shape),
        "n_devices": cmesh.size,
        "rank": cmesh.rank,
        "route": "ref",
        "params": param_count(model.specs),
        "param_bytes": param_bytes(model.specs),
    }
    rec.update(count_step(model, shape, cmesh, run))
    rec["ok"] = True
    return rec


def run_cell(arch: str, shape: ShapeConfig, mesh, run: RunConfig,
             verbose: bool = True) -> dict:
    """The record of ``arch``'s cell ``shape`` on ``mesh``'s rank 0 (or
    the rank of a ``CountingMesh``; see the module doc)."""
    rec = cell_record(get_config(arch), shape, mesh, run)
    rec["arch"] = arch
    if verbose:
        coll = sum(rec["collective_bytes_per_device"].values())
        print(f"[dryrun] {arch} x {shape.name} x {rec['mesh']}: "
              f"flops/dev={rec['flops_per_device']:.3e} "
              f"bytes/dev={rec['bytes_accessed_per_device']:.3e} "
              f"coll={coll:.3e}B "
              f"mem(temp)={rec['memory']['temp_size'] / 2**30:.2f}GiB "
              f"trace={rec['trace_s']:.0f}s", flush=True)
        print("  memory:", {k: f"{v / 2**30:.2f}GiB"
                            for k, v in rec["memory"].items()}, flush=True)
    return rec


def default_run(shape: ShapeConfig) -> RunConfig:
    return RunConfig(remat="full", attn_chunk_q=1024, attn_chunk_kv=1024,
                     ssm_chunk=256)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list(ARCH_NAMES))
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    meshes = []
    if not args.multi_pod_only:
        meshes.append(("single_pod", make_production_mesh(multi_pod=False)))
    if not args.single_pod_only:
        meshes.append(("multi_pod", make_production_mesh(multi_pod=True)))

    archs = list(ARCH_NAMES) if args.all or not args.arch else [args.arch]
    results = []
    for mesh_name, mesh in meshes:
        for arch in archs:
            cfg = get_config(arch)
            shapes = shapes_for(cfg)
            if args.shape:
                shapes = [s for s in shapes if s.name == args.shape]
            for shape in shapes:
                try:
                    rec = run_cell(arch, shape, mesh, default_run(shape))
                except Exception as e:  # noqa: BLE001 — report, don't die
                    traceback.print_exc()
                    rec = {"arch": arch, "shape": shape.name,
                           "mesh_name": mesh_name, "ok": False,
                           "error": repr(e)}
                rec["mesh_name"] = mesh_name
                results.append(rec)

    n_ok = sum(r["ok"] for r in results)
    print(f"\n[dryrun] {n_ok}/{len(results)} cells traced OK")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"[dryrun] wrote {args.out}")
    if n_ok != len(results):
        raise SystemExit(1)


if __name__ == "__main__":
    main()

"""Per-rank FLOPs of one reduced dry-run cell, op by op, in both packages:
the port's (``repro_torch.launch.dryrun`` on the meta device: each
product FlopCounterMode counts, by op and operand shapes) beside
``repro``'s (``repro.launch.dryrun.run_cell``'s compiled HLO: each dot,
by operand shapes, times its enclosing loops' trip counts, as
``repro.launch.hlo_cost`` counts them).  It names the ops behind a gap
between the two records.

    PYTHONPATH=src python scripts/dryrun_by_op.py --arch yi-9b --kind prefill

The cell is ``tests/mesh_model_pair.py``'s: the reduced config, 8 rows x
32 tokens, its RUN_KNOBS, on a (2, 4) ("data", "model") mesh (8 fake CPU
devices for ``repro``, rank 0 of a counting mesh for the port).
"""
import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import argparse  # noqa: E402
import collections  # noqa: E402
import re  # noqa: E402

import jax  # noqa: E402
import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils.flop_counter import flop_registry  # noqa: E402

MESH, AXES = (2, 4), ("data", "model")
ROWS, SEQ = 8, 32
KNOBS = dict(remat="none", attn_chunk_q=16, attn_chunk_kv=16,
             learning_rate=1e-3, warmup_steps=2, total_steps=100)


class ByOp(TorchDispatchMode):
    """FlopCounterMode's formula of each product, summed by (op, operand
    shapes)."""

    def __init__(self):
        super().__init__()
        self.flops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            shapes = tuple(tuple(a.shape) for a in args
                           if isinstance(a, torch.Tensor))
            self.flops[(func._overloadpacket.__name__, shapes)] += formula(
                *args, **kwargs, out_val=out)
        return out


def port_by_op(arch: str, kind: str):
    from repro_torch import configs
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.launch import dryrun
    # Only the step makes products (its inputs are empty meta tensors).
    with ByOp() as by_op:
        rec = dryrun.cell_record(
            configs.get_reduced_config(arch),
            ShapeConfig(f"reduced_{kind}", SEQ, ROWS, kind),
            dryrun.CountingMesh(MESH, AXES), RunConfig(**KNOBS))
    return rec["flops_per_device"], by_op.flops


def repro_by_op(arch: str, kind: str):
    import repro.launch.dryrun as jd
    from repro import configs
    from repro.configs.base import RunConfig, ShapeConfig
    from repro.launch import hlo_cost
    from repro.launch.mesh import make_test_mesh
    texts, real = [], jd.cost_of

    def keep(text, *args, **kwargs):
        texts.append(text)
        return real(text, *args, **kwargs)
    jd.cost_of, jd.get_config = keep, configs.get_reduced_config
    rec = jd.run_cell(arch, ShapeConfig(f"reduced_{kind}", SEQ, ROWS, kind),
                      make_test_mesh(MESH), RunConfig(**KNOBS),
                      verbose=False)
    comps, shapes = hlo_cost.parse_hlo(texts[0])
    flops = collections.Counter()

    def walk(name, mult, seen=()):
        for op in comps.get(name, ()):
            if op.opcode == "dot":
                args = re.findall(r"%([\w.\-]+)", op.rest)[:2]
                key = ("dot", tuple(tuple(hlo_cost._type_dims(
                    shapes.get(a, "")) or ()) for a in args))
                flops[key] += mult * hlo_cost._dot_flops(op, shapes)
            elif op.opcode == "while":
                trips = hlo_cost._TRIP_RE.search(op.rest)
                body = hlo_cost._BODY_RE.search(op.rest)
                if body and body.group(1) not in seen:
                    walk(body.group(1), mult * (int(trips.group(1))
                                                if trips else 1),
                         seen + (body.group(1),))
            elif op.opcode in ("call", "conditional", "fusion"):
                callee = hlo_cost._CALLS_RE.search(op.rest)
                if callee and callee.group(1) not in seen:
                    walk(callee.group(1), mult, seen + (callee.group(1),))
    entry = next(k for k, v in comps.items()
                 if v is comps["__entry__"] and k != "__entry__")
    walk(entry, 1)
    return int(rec["flops_per_device"]), flops


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--kind", default="prefill",
                    choices=("train", "prefill", "decode"))
    args = ap.parse_args()
    if jax.device_count() != 8:
        raise SystemExit(f"needs 8 CPU devices (XLA_FLAGS), has "
                         f"{jax.device_count()}")
    for side, (total, flops) in (("port", port_by_op(args.arch, args.kind)),
                                 ("repro", repro_by_op(args.arch,
                                                       args.kind))):
        print(f"{side}: {total} FLOPs a rank ({sum(flops.values()):.0f} "
              f"listed)")
        for (op, shapes), n in flops.most_common():
            print(f"  {int(n):>12d}  {op} {shapes}")


if __name__ == "__main__":
    main()

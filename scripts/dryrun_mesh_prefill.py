"""The dry-run's count of one rank of ``scripts/torch_mesh_prefill.py``'s
forward (its arch at full depth, its batch x SEQ tokens, its run knobs,
the serving build) on the meta device: the rank's blocks, the most
compute-tree bytes the step holds at once and the whole tree's, the
argument + temp bytes a card needs, the collectives by kind.  The step
gathers a block at a time (ROADMAP item 7e); ``whole_tree`` is what
gathering every leaf at once holds (the leaves that are the rank's
blocks themselves, such as the experts, included).

    PYTHONPATH=src python scripts/dryrun_mesh_prefill.py --mesh 2 2
    PYTHONPATH=src python scripts/dryrun_mesh_prefill.py \\
        --arch llama-3.2-vision-90b --mesh 2 2
    PYTHONPATH=src python scripts/dryrun_mesh_prefill.py --layers 2 \\
        --batch 4 --mesh 2 2           # chip_smoke.py phase 14 (a)'s cell
    PYTHONPATH=src python scripts/dryrun_mesh_prefill.py --mesh 4
"""
import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from torch_mesh_prefill import BATCHES, SEQ, mesh_axes  # noqa: E402

GIB = 2 ** 30


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mixtral-8x7b", choices=sorted(BATCHES))
    ap.add_argument("--layers", type=int, default=0,
                    help="layers (default: the config's)")
    ap.add_argument("--batch", type=int, default=0,
                    help="rows (default: the script's for the arch)")
    ap.add_argument("--mesh", type=int, nargs="+", default=[2, 2],
                    help="data extent, or data and model extents")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    cfg = dataclasses.replace(cfg, n_layers=args.layers or cfg.n_layers)
    shape = ShapeConfig("mesh_prefill", SEQ,
                        args.batch or BATCHES[args.arch], "prefill")
    rec = dryrun.count_step(build_model(cfg, "meta"), shape,
                            dryrun.CountingMesh(args.mesh,
                                                mesh_axes(args.mesh)),
                            serve_mod.run_config(SEQ))
    mem = rec["memory"]
    need = mem["argument_size"] + mem["temp_size"]
    print(json.dumps(dict(
        arch=cfg.name, layers=cfg.n_layers, mesh=args.mesh,
        batch=shape.global_batch, seq=SEQ,
        block_gib=rec["block_bytes"] / GIB, tree_gib=rec["tree_bytes"] / GIB,
        whole_tree_gib=rec["whole_tree_bytes"] / GIB,
        argument_plus_temp_gib=need / GIB,
        collective_counts=rec["collective_counts"],
        collective_gb={k: v / 1e9 for k, v in
                       rec["collective_bytes_per_device"].items()},
        flops=rec["flops_per_device"])))


if __name__ == "__main__":
    main()

"""A rank's count of an MoE arch's train_4k step on a mesh without
"model" (ROADMAP item 7f) against one process's, by the port's dry-run
on the meta device.

On a ("data",) mesh of n ranks, every rank gathers the batch's rows,
routes them and builds the one capacity plan of C slots an expert that
one process would build, and runs the experts on its own slice of each
expert's slots, ceil(C / n) of them (``models.moe``).  So the experts'
FLOPs a rank are ceil(C / n) / C of one process's, like the rest of the
step's 1 / n, and each MoE layer adds an all-gather of the experts'
[E, n ceil(C / n), D] outputs (its backward a reduce-scatter of the same
size) to the rows' gather.  Printed for (n,) and (1,): a rank's FLOPs,
its collectives' result bytes and calls by kind, and its argument +
temp bytes; then the FLOPs ratio.

    PYTHONPATH=src python scripts/dryrun_moe_data_mesh.py --arch mixtral-8x7b --ranks 16
    PYTHONPATH=src python scripts/dryrun_moe_data_mesh.py --arch deepseek-v2-236b --ranks 16
"""
import argparse
import json

from repro_torch.configs import ARCH_NAMES
from repro_torch.configs.base import TRAIN_4K
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import AbstractMesh


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x7b", choices=ARCH_NAMES)
    ap.add_argument("--ranks", type=int, default=16)
    args = ap.parse_args()
    n = args.ranks
    recs = {}
    for size in (n, 1):
        rec = dryrun.run_cell(args.arch, TRAIN_4K,
                              AbstractMesh((size,), ("data",)),
                              dryrun.default_run(TRAIN_4K), verbose=False)
        mem = rec["memory"]
        recs[size] = dict(
            mesh=[size], flops=rec["flops_per_device"],
            collective_bytes=rec["collective_bytes_per_device"],
            collective_counts=rec["collective_counts"],
            argument_plus_temp=mem["argument_size"] + mem["temp_size"])
        print(json.dumps(dict(arch=args.arch, shape=TRAIN_4K.name,
                              **recs[size])))
    print(f"{args.arch} train_4k on ({n},) ('data',): {recs[n]['flops']:.4g} "
          f"FLOPs a rank, {recs[n]['flops'] / recs[1]['flops']:.4g} of one "
          f"process's {recs[1]['flops']:.4g}")


if __name__ == "__main__":
    main()

"""The expert FLOPs a rank repeats when `moe_ffn` runs on a mesh without
"model" (ROADMAP item 7f), counted by the port's dry-run on the meta
device.

On a ("data",) mesh of n ranks every rank gathers the batch's rows and
runs all experts over the whole batch, while the rest of the step is
split n ways.  So a rank's FLOPs on (n,) are E + R / n and one process's
on (1,) are E + R, where E is the experts' FLOPs over the whole batch
and R the rest: E = (F_n - F_1 / n) * n / (n - 1).  A global capacity
plan would leave E / n to a rank.

    PYTHONPATH=src python scripts/dryrun_moe_data_mesh.py --arch mixtral-8x7b --ranks 16
"""
import argparse

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
    flops = {}
    for size in (n, 1):
        rec = dryrun.run_cell(args.arch, TRAIN_4K,
                              AbstractMesh((size,), ("data",)),
                              dryrun.default_run(TRAIN_4K))
        flops[size] = rec["flops_per_device"]
    experts = (flops[n] - flops[1] / n) * n / (n - 1)
    print(f"{args.arch} train_4k on ({n},) ('data',): {flops[n]:.4g} FLOPs "
          f"a rank, of which {experts:.4g} the experts over the whole "
          f"batch; a global plan would leave {experts / n:.4g} of those, "
          f"{flops[n] - experts + experts / n:.4g} a rank in all")


if __name__ == "__main__":
    main()

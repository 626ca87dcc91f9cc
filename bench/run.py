"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload synth3k_fast.inblock --seed 7 \
        --seconds 20 --trace 0

From the root of a checkout.  ``--trace 0`` prints the cell's end-to-end
metrics, ``--trace 1`` its per-layer ones (see ``bench/harness.py``).  The
last line of standard output is the result's JSON; the last lines of
standard error name each number the check compared, beside its limit.
Without enough CUDA devices, or with JAX or the JAX package loaded, it
exits non-zero and prints no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    cache = os.path.join(ROOT, "bench", "cache")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(cache, "torch_extensions"))
    import torch
    from bench import harness
    chips = int(harness.Spec(ROOT).workload(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    line = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                            bool(args.trace), "cuda", T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"the run loaded {found}: nothing it runs may load JAX or "
              f"the JAX package", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']} {c['rule']} {c['limit']}",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())

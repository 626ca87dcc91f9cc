"""The upper readings a cell's limit is set from, at the cell's own size.

    python3 bench/control.py --workload synth3k_fast.inblock \
        --seeds 1 2 3 --seconds 5

For each seed, a whole run of the cell (``harness.run_cell``: the cell's
traffic pool, window, kept rows and check) with the timed path replaced:

* ``control_bf16``: the plain reference with its crossing arithmetic in
  bfloat16, the precision below the configuration's float32, put in the
  program's place (each distinct batch worked out once; the program still
  runs each batch, so the window checks as many rows as a run does);
* ``control_approx``: where the artifact has a cell index, the program's
  own approximate path (``mode="approx"``: the boundary cell's centre
  owner).

One JSON line a run, with its checks and ``correct``.  It exits non-zero
if a bfloat16 run reads ``correct``.  The benchmark's runs never run
this; it needs the card, as they do.
"""
import argparse
import json
import os
import sys
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def bf16_hook(ref_low):
    """An engine hook that puts ``ref_low`` in the program's place."""
    memo = {}

    def hook(engine):
        real = engine.assign

        def assign(points):
            real(points)            # the window keeps the program's pace
            key = points.data_ptr()
            if key not in memo:
                ids, _ = ref_low.ids(points)
                memo[key] = types.SimpleNamespace(
                    state=ids[:, 0], county=ids[:, 1], block=ids[:, 2],
                    stats=None)
            return memo[key]
        engine.assign = assign
        return engine
    return hook


def approx_hook(art_dir, dev):
    """An engine hook that runs the program's approximate path."""
    def hook(engine):
        from repro_torch.core.artifact import GeoIndexSet
        from repro_torch.core.engine import EngineConfig, GeoEngine
        return GeoEngine.from_index_set(
            GeoIndexSet.load(str(art_dir / "artifact"), device=dev),
            strategy="fast", cfg=EngineConfig(mode="approx"))
    return hook


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=ROOT,
                    help="the checkout whose BENCHMARK.json names the cell")
    args = ap.parse_args(argv)
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import torch
    from bench import harness
    dev = torch.device(args.device)
    spec = harness.Spec(args.root)
    cfg = spec.config(spec.workload(args.workload)["config"])
    art_dir, _ = harness.ensure_artifact(spec.root, cfg)
    low = harness.reference_class(cfg)(harness.load_census(art_dir), dev,
                                       dtype=torch.bfloat16)
    hooks = {"control_bf16": lambda: bf16_hook(low)}
    if "covering" in cfg["artifact"]:
        hooks["control_approx"] = lambda: approx_hook(art_dir, dev)
    ok = True
    for seed in args.seeds:
        for name, make in hooks.items():
            t0 = time.perf_counter()
            line = harness.run_cell(args.root, args.workload, seed,
                                    args.seconds, False, dev,
                                    time.perf_counter(), engine_hook=make())
            out = {"workload": args.workload, "seed": seed, "side": name,
                   "correct": line["correct"],
                   **{k: c["value"] for k, c in line["checks"].items()},
                   "seconds": time.perf_counter() - t0}
            print(json.dumps(out), flush=True)
            ok &= not (name == "control_bf16" and line["correct"])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

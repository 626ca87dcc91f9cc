"""Training launcher (port of src/repro/launch/train.py).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --reduced --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/ck

Runs the fault-tolerant driver (checkpoint/restart, straggler watch) on
the card (``--device cuda``, the default, never swapped for the CPU when
there is no card); ``--device cpu`` asks for the same path on the
kernels' plain twins (``--reduced`` sizes, in practice).  The weights are
f32 master weights, random from ``--seed`` (a ``torch.Generator`` on the
device).  ``--geo-enrich`` joins synthetic locations onto census blocks
in the pipeline (the paper's technique): the synthetic census's covering
and a ``fast`` approx engine on the device.  One device, no mesh: the
mesh and ``repro``'s XLA flags come with the distributed slice.
``setup`` / ``run_config`` / ``geo_index`` are the pieces ``main``
composes with ``train_loop`` over ``make_train_step`` (chip_smoke.py
drives them).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import ARCH_NAMES, get_config, get_reduced_config
from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.data.pipeline import make_source
from repro_torch.models.model import build_model
from repro_torch.models.module import init_params_into
from repro_torch.optim import adamw
from repro_torch.runtime.driver import DriverConfig, train_loop
from repro_torch.runtime.steps import make_train_step


def run_config(arch: str, steps: int, seq: int, *, lr: float = 1e-3,
               schedule: str = "cosine", microbatch: int = 0,
               remat: str = "none", seed: int = 0) -> RunConfig:
    """``repro``'s launcher knobs: MiniCPM trains with WSD (its signature
    feature); warmup is 5 % of the steps; attention chunks of 128."""
    sched = "wsd" if arch == "minicpm-2b" else schedule
    return RunConfig(remat=remat, learning_rate=lr, schedule=sched,
                     total_steps=steps, warmup_steps=max(steps // 20, 1),
                     microbatch=microbatch, attn_chunk_q=min(128, seq),
                     attn_chunk_kv=min(128, seq),
                     ssm_chunk=min(64, seq), seed=seed)


def setup(cfg: ModelConfig, *, seed: int = 0, device="cuda"):
    """``cfg``'s model built to train on ``device`` with random f32
    weights from ``seed``; returns (model, params {name: parameter},
    fresh AdamW state)."""
    model = build_model(cfg, device, trainable=True)
    init_params_into(model, torch.Generator(device=device).manual_seed(seed))
    params = dict(model.named_parameters())
    return model, params, adamw.init(params)


def geo_index(device="cuda"):
    """``repro``'s ``--geo-enrich`` pair: the synthetic census's (seed 1)
    covering at max_level 8 as a ``FastIndex`` on ``device``, and the
    ``fast`` approx config (``make_source`` wraps it in an engine)."""
    from repro_torch.core.cells import build_cell_covering
    from repro_torch.core.fast import FastConfig, FastIndex
    from repro_torch.core.synth import build_synth_census
    sc = build_synth_census(seed=1)
    cov = build_cell_covering(sc.census, max_level=8)
    return (FastIndex.from_covering(cov, sc.census, gbits=4, device=device),
            FastConfig(mode="approx"))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=ARCH_NAMES)
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--schedule", default="cosine",
                    choices=("cosine", "wsd", "const"))
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--remat", default="none",
                    choices=("none", "dots", "full"))
    ap.add_argument("--ckpt-dir", default="/tmp/repro_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--geo-enrich", action="store_true",
                    help="join synthetic locations onto census blocks in "
                         "the pipeline (the paper's technique)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_reduced_config(args.arch) if args.reduced \
        else get_config(args.arch)
    run = run_config(args.arch, args.steps, args.seq, lr=args.lr,
                     schedule=args.schedule, microbatch=args.microbatch,
                     remat=args.remat, seed=args.seed)
    model, params, opt = setup(cfg, seed=args.seed, device=args.device)
    print(f"[train] {cfg.name}: {model.param_count():,} params, on "
          f"{args.device}")

    geo = None
    if args.geo_enrich:
        geo = geo_index(args.device)
        print(f"[train] geo enrichment on: {geo[0].cell_lo.shape[0]} cells")
    shape = ShapeConfig("train", args.seq, args.batch, "train")
    src = make_source(cfg, shape, seed=args.seed, geo=geo,
                      device=args.device)
    dcfg = DriverConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                        ckpt_dir=args.ckpt_dir)
    params, opt, hist = train_loop(make_train_step(model, run), params, opt,
                                   src, dcfg)
    print(f"[train] done: loss {hist['loss'][0]:.4f} -> "
          f"{hist['loss'][-1]:.4f}, {hist['steps_run']} steps, "
          f"{hist['restarts']} restarts, {hist['stragglers']} stragglers")


if __name__ == "__main__":
    main()

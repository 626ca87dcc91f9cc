"""End-to-end driver on the PyTorch + CUDA port (twin of
examples/train_lm.py): train a ~100M-param dense LM with geo-enriched
synthetic data, checkpoints and an injected failure.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 300]   # cuda
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu \\
        --steps 4 --batch 2 --seq 64      # a few steps on the CPU twins
"""
import argparse
import shutil

from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.data.pipeline import make_source
from repro_torch.launch.train import geo_index, setup
from repro_torch.runtime.driver import DriverConfig, train_loop
from repro_torch.runtime.steps import make_train_step

# ~103M params: 12L x 768d, llama-style.
CFG = ModelConfig(name="demo-100m", family="dense", n_layers=12,
                  d_model=768, n_heads=12, n_kv_heads=4, d_ff=2048,
                  vocab=32000, act="swiglu")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_torch_train_lm")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    shutil.rmtree(args.ckpt_dir, ignore_errors=True)

    run = RunConfig(remat="none", learning_rate=3e-4, schedule="cosine",
                    total_steps=args.steps, warmup_steps=20,
                    attn_chunk_q=128, attn_chunk_kv=128)
    model, params, opt = setup(CFG, seed=0, device=args.device)
    print(f"[example] {CFG.name}: {model.param_count()/1e6:.1f}M params "
          f"on {args.device}")

    # Geo-enriched pipeline: each sequence carries a location joined onto
    # the synthetic census via the paper's fast index.
    src = make_source(CFG, ShapeConfig("train", args.seq, args.batch,
                                       "train"),
                      seed=0, geo=geo_index(args.device), device=args.device)

    dcfg = DriverConfig(total_steps=args.steps, ckpt_every=100,
                        ckpt_dir=args.ckpt_dir, log_every=20)
    # Inject one failure mid-run to demonstrate checkpoint/restart.
    params, opt, hist = train_loop(make_train_step(model, run), params, opt,
                                   src, dcfg, fail_at={args.steps // 2})
    print(f"[example] loss {hist['loss'][0]:.3f} -> {hist['loss'][-1]:.3f} "
          f"({hist['steps_run']} steps, {hist['restarts']} restart)")
    assert hist["loss"][-1] < hist["loss"][0]


if __name__ == "__main__":
    main()

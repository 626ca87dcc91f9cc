"""Serve a small LM with batched requests on the PyTorch + CUDA port (twin
of examples/serve_lm.py): prefill + greedy decode with a KV cache,
reporting tokens/s.

    PYTHONPATH=src python examples/torch_serve_lm.py                # cuda
    PYTHONPATH=src python examples/torch_serve_lm.py --device cpu
"""
import argparse

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.serve import load_model, make_prompts, serve

CFG = ModelConfig(name="demo-serve-25m", family="dense", n_layers=6,
                  d_model=512, n_heads=8, n_kv_heads=4, d_ff=1408,
                  vocab=32000, act="swiglu")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    args = ap.parse_args(argv)
    model = load_model(CFG, seed=0, device=args.device)
    print(f"[serve_lm] {model.param_count() / 1e6:.1f}M params on "
          f"{args.device}")

    batch, prompt_len, gen = args.batch, args.prompt_len, args.gen
    prompts = make_prompts(CFG, batch, prompt_len, seed=0,
                           device=args.device)
    serve(model, prompts, gen)                 # warm-up (kernel builds)
    res = serve(model, prompts, gen)
    out = res.tokens.cpu().numpy()
    print(f"[serve_lm] prefill {batch}x{prompt_len}: "
          f"{res.prefill_tok_s():.0f} tok/s; decode: "
          f"{res.decode_tok_s():.0f} tok/s")
    print("[serve_lm] first sequence:", out[0][:16])
    assert out.shape == (batch, gen)
    return out


if __name__ == "__main__":
    main()

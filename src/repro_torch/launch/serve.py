"""Serving launcher (port of src/repro/launch/serve.py): prefill a batch of
prompts, then decode greedily.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
      --batch 8 --prompt-len 2048 --gen 64

A model without ``prefill`` (the MoE family, as in ``repro``) takes its
prompt one token at a time through the decode step, as ``repro``'s
launcher does; the "prefill" phase is then that loop.

Runs on the card (``--device cuda``, the default, never swapped for the
CPU when there is no card); ``--device cpu`` asks for the same path on
the kernels' plain twins (``--reduced`` sizes, in practice).  The
weights are random, drawn from ``--seed`` with a ``torch.Generator`` on
the device; the prompts come from numpy's generator with the same seed,
as in ``repro``.
``serve`` is the work, callable on its own (chip_smoke.py drives it).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs import ARCH_NAMES, get_config, get_reduced_config
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models.model import Model, build_model
from repro_torch.models.module import init_params_into
from repro_torch.runtime.steps import make_serve_step


@dataclasses.dataclass
class ServeResult:
    """What ``serve`` produced: the generated tokens [B, gen] i32 (the
    first from the prefill's logits, one per decode step after it), the
    prefill's last-position logits [B, V] f32 (the last prompt step's,
    for a model fed token by token), the prompt length, the
    host seconds of each phase (each ends in a device sync), and the
    run's peak device memory above what was allocated when it started
    (the weights and whatever else the caller holds; CUDA only, else
    None)."""

    tokens: torch.Tensor
    prefill_logits: torch.Tensor
    prompt_len: int
    prefill_s: float
    decode_s: float
    peak_bytes: Optional[int]

    def prefill_tok_s(self) -> float:
        return self.tokens.shape[0] * self.prompt_len / self.prefill_s

    def decode_tok_s(self) -> float:
        b, gen = self.tokens.shape
        return (gen - 1) * b / max(self.decode_s, 1e-9)


def load_model(cfg: ModelConfig, *, seed: int = 0, device="cuda") -> Model:
    """``cfg``'s model on ``device`` with random weights from ``seed``
    (drawn leaf by leaf into the parameters: ``init_params_into``)."""
    model = build_model(cfg, device)
    init_params_into(model, torch.Generator(device=device).manual_seed(seed))
    return model


def make_prompts(cfg: ModelConfig, batch: int, prompt_len: int, seed: int,
                 device) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(0, cfg.vocab, (batch, prompt_len)),
                           dtype=torch.int32, device=device)


def run_config(prompt_len: int) -> RunConfig:
    """``repro``'s serving knobs (the attention chunks feed only the
    sliding-window path; the flash kernel has its own tiles)."""
    return RunConfig(remat="none", attn_chunk_q=min(128, prompt_len),
                     attn_chunk_kv=min(128, prompt_len))


def serve(model: Model, prompts: torch.Tensor, gen: int, *,
          on_phase: Optional[Callable[[str, str], None]] = None
          ) -> ServeResult:
    """Prefill ``prompts`` [B, S] once (or, for a model without
    ``prefill``, feed them one token at a time through ``decode_step``),
    then ``gen - 1`` greedy decode steps.  ``on_phase(phase, edge)`` is
    called with ("prefill" |
    "decode", "start" | "end") right before each phase is driven and
    right after its device work has finished."""
    b, s = prompts.shape
    run = run_config(s)
    cuda = prompts.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    phase = on_phase or (lambda name, edge: None)
    serve_step = make_serve_step(model, run)
    base = 0
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    with torch.inference_mode():
        sync()
        phase("prefill", "start")
        t0 = time.perf_counter()
        if hasattr(model, "prefill"):
            logits, cache = model.prefill(run, prompts, s + gen)
        else:
            cache = model.init_cache(b, s + gen)
            for t in range(s):
                logits, cache = model.decode_step(run, prompts[:, t:t + 1],
                                                  cache)
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        sync()
        prefill_s = time.perf_counter() - t0
        phase("prefill", "end")
        out = [tok]
        phase("decode", "start")
        t0 = time.perf_counter()
        for _ in range(gen - 1):
            tok, cache = serve_step(tok, cache)
            out.append(tok)
        sync()
        decode_s = time.perf_counter() - t0
        phase("decode", "end")
    return ServeResult(
        tokens=torch.cat(out, dim=1), prefill_logits=logits[:, -1],
        prompt_len=s, prefill_s=prefill_s, decode_s=decode_s,
        peak_bytes=torch.cuda.max_memory_allocated() - base if cuda
        else None)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=ARCH_NAMES)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_reduced_config(args.arch) if args.reduced \
        else get_config(args.arch)
    model = load_model(cfg, seed=args.seed, device=args.device)
    prompts = make_prompts(cfg, args.batch, args.prompt_len, args.seed,
                           args.device)
    res = serve(model, prompts, args.gen)
    print(f"[serve] {cfg.name}: prefill {args.batch}x{args.prompt_len} in "
          f"{res.prefill_s*1e3:.0f}ms ({res.prefill_tok_s():.1f} tok/s); "
          f"{args.gen - 1} decode steps in {res.decode_s*1e3:.0f}ms "
          f"({res.decode_tok_s():.1f} tok/s)"
          + ("" if res.peak_bytes is None else
             f"; peak device memory {res.peak_bytes / 2**30:.2f} GiB above "
             f"the weights"))
    print("[serve] sample generation (first row):",
          res.tokens[0][:12].cpu().numpy(), "...")


if __name__ == "__main__":
    main()

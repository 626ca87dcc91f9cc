"""Mixtral-8x7B: 8-expert top-2 MoE with sliding-window attention
[arXiv:2401.04088].  SWA rolling cache -> sub-quadratic decode, runs
long_500k."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=32000, act="swiglu", rope_theta=1_000_000.0,
    sliding_window=4096,
    n_experts=8, top_k=2, d_ff_expert=14336,
    subquadratic=True,
)

REDUCED = ModelConfig(
    name="mixtral-8x7b-reduced", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=160, vocab=512, act="swiglu",
    sliding_window=32,
    n_experts=4, top_k=2, d_ff_expert=160,
    subquadratic=True,
)

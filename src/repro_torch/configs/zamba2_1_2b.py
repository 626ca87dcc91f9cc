"""Zamba2-1.2B: Mamba2 backbone with a shared attention+MLP block invoked
every 6 layers (per-invocation LoRA on q) [arXiv:2411.15242].
Sub-quadratic -> runs the long_500k cell."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="ssm_hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32000, act="swiglu",
    ssm_state=64, ssm_head_dim=64, ssm_expand=2,
    shared_attn_every=6, shared_lora_rank=128,
    subquadratic=True,
)

REDUCED = ModelConfig(
    name="zamba2-1.2b-reduced", family="ssm_hybrid",
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=256, vocab=512, act="swiglu",
    ssm_state=16, ssm_head_dim=16, ssm_expand=2,
    shared_attn_every=2, shared_lora_rank=8,
    subquadratic=True,
)

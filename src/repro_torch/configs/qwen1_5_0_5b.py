"""Qwen1.5-0.5B: dense decoder, MHA with QKV bias [hf:Qwen/Qwen1.5-0.5B]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b", family="dense",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=2816, vocab=151936, qkv_bias=True, act="swiglu",
)

REDUCED = ModelConfig(
    name="qwen1.5-0.5b-reduced", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=176, vocab=512, qkv_bias=True, act="swiglu",
)

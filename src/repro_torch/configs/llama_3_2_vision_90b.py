"""Llama-3.2-Vision-90B backbone: dense decoder with gated cross-attention
image layers every 5th layer.  The vision tower is a STUB — input_specs()
provides precomputed patch embeddings [B, n_img_tokens, d_vision]
[hf:meta-llama/Llama-3.2-11B-Vision]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b", family="vlm",
    n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab=128256, rope_theta=500_000.0, act="swiglu",
    cross_attn_every=5, n_img_tokens=1600, d_vision=1280,
)

REDUCED = ModelConfig(
    name="llama-3.2-vision-90b-reduced", family="vlm",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=176, vocab=512, rope_theta=500_000.0, act="swiglu",
    cross_attn_every=2, n_img_tokens=16, d_vision=48,
)

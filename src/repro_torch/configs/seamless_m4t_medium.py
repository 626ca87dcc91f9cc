"""SeamlessM4T-medium backbone: encoder-decoder transformer.  The speech
frontend is a STUB — input_specs() provides precomputed frame embeddings
[B, S, d_model].  RoPE replaces the original relative positions (TPU
adaptation, DESIGN.md) [arXiv:2308.11596]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="encdec",
    n_layers=12, enc_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=256206, act="gelu",
)

REDUCED = ModelConfig(
    name="seamless-m4t-medium-reduced", family="encdec",
    n_layers=2, enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=256, vocab=512, act="gelu",
)

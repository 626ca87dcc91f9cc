"""Yi-9B: llama-arch dense decoder with GQA [arXiv:2403.04652]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b", family="dense",
    n_layers=48, d_model=4096, n_heads=32, n_kv_heads=4,
    d_ff=11008, vocab=64000, rope_theta=5_000_000.0, act="swiglu",
)

REDUCED = ModelConfig(
    name="yi-9b-reduced", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=176, vocab=512, rope_theta=5_000_000.0, act="swiglu",
)

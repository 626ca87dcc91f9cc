"""MiniCPM-2B: llama-like dense decoder, tied embeddings; trained with the
WSD schedule (see optim/schedules.py) [arXiv:2404.06395]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b", family="dense",
    n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36,
    d_ff=5760, vocab=122753, act="swiglu", tie_embeddings=True,
)

REDUCED = ModelConfig(
    name="minicpm-2b-reduced", family="dense",
    n_layers=2, d_model=72, n_heads=6, n_kv_heads=6,
    d_ff=180, vocab=512, act="swiglu", tie_embeddings=True,
)

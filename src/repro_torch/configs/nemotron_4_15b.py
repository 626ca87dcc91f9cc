"""Nemotron-4-15B: dense decoder, GQA, squared-ReLU MLP [arXiv:2402.16819]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b", family="dense",
    n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=24576, vocab=256000, act="relu2",
)

REDUCED = ModelConfig(
    name="nemotron-4-15b-reduced", family="dense",
    n_layers=2, d_model=96, n_heads=6, n_kv_heads=2,
    d_ff=384, vocab=512, act="relu2",
)

"""xLSTM-1.3B: mLSTM blocks with an sLSTM block every 8th layer
[arXiv:2405.04517].  Constant-size recurrent state -> runs long_500k."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="xlstm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304, slstm_every=8,
    subquadratic=True,
)

REDUCED = ModelConfig(
    name="xlstm-1.3b-reduced", family="xlstm",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=512, slstm_every=2,
    subquadratic=True,
)

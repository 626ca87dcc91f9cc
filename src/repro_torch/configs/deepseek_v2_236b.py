"""DeepSeek-V2-236B: MLA (kv_lora=512) + MoE with 2 shared + 160 routed
experts, top-6; first layer dense [arXiv:2405.04434]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
    d_ff=12288, vocab=102400, act="swiglu",
    mla=True, q_lora=1536, kv_lora=512,
    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128, head_dim=192,
    n_experts=160, n_shared_experts=2, top_k=6, d_ff_expert=1536,
    first_dense_layers=1,
)

REDUCED = ModelConfig(
    name="deepseek-v2-236b-reduced", family="moe",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=160, vocab=512, act="swiglu",
    mla=True, q_lora=48, kv_lora=32,
    qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16, head_dim=24,
    n_experts=8, n_shared_experts=2, top_k=2, d_ff_expert=48,
    first_dense_layers=1,
)

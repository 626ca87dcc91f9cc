"""Config dataclasses for models, input shapes and runs."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm_hybrid | xlstm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None

    # attention
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None

    # mlp
    act: str = "swiglu"         # swiglu | relu2 | gelu

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # MLA (deepseek-v2)
    mla: bool = False
    q_lora: int = 0
    kv_lora: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # SSM / hybrid (mamba2 / zamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    shared_attn_every: int = 0   # zamba2: shared attn block cadence
    shared_lora_rank: int = 0

    # xLSTM
    slstm_every: int = 0         # 0 = all mLSTM

    # VLM (llama-3.2-vision)
    cross_attn_every: int = 0
    n_img_tokens: int = 0
    d_vision: int = 0

    # enc-dec (seamless-m4t)
    enc_layers: int = 0

    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # Sub-quadratic context support (decides long_500k applicability).
    subquadratic: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_decoder_only(self) -> bool:
        return self.family not in ("encdec",)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One benchmark cell: an input shape + which step it exercises."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def shapes_for(cfg: ModelConfig) -> tuple[ShapeConfig, ...]:
    """Shape cells applicable to an architecture (see DESIGN.md §4)."""
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.subquadratic:
        out.append(LONG_500K)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Execution knobs for a step (static; part of jit key)."""

    microbatch: int = 0          # 0 = no gradient accumulation
    remat: str = "full"          # none | dots | full
    attn_chunk_q: int = 1024
    attn_chunk_kv: int = 1024
    ssm_chunk: int = 256
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    schedule: str = "cosine"     # cosine | wsd | const
    warmup_steps: int = 100
    total_steps: int = 10000
    z_loss: float = 1e-4
    seed: int = 0

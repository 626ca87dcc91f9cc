"""Architecture registry: --arch <id> resolves here (a copy of
src/repro/configs; the configs are data only)."""
from repro_torch.configs import (deepseek_v2_236b, llama_3_2_vision_90b,
                                 minicpm_2b, mixtral_8x7b, nemotron_4_15b,
                                 qwen1_5_0_5b, seamless_m4t_medium,
                                 xlstm_1_3b, yi_9b, zamba2_1_2b)
from repro_torch.configs.base import (ALL_SHAPES, DECODE_32K, LONG_500K,
                                      PREFILL_32K, TRAIN_4K, ModelConfig,
                                      RunConfig, ShapeConfig, shapes_for)

# The registry is also the convenience surface for the shape/run presets:
# callers import everything config-shaped from ``repro_torch.configs``.
__all__ = ["ALL_SHAPES", "ARCH_NAMES", "DECODE_32K", "LONG_500K",
           "ModelConfig", "PREFILL_32K", "RunConfig", "ShapeConfig",
           "TRAIN_4K", "get_config", "get_reduced_config", "shapes_for"]

_MODULES = {
    "yi-9b": yi_9b,
    "qwen1.5-0.5b": qwen1_5_0_5b,
    "nemotron-4-15b": nemotron_4_15b,
    "minicpm-2b": minicpm_2b,
    "llama-3.2-vision-90b": llama_3_2_vision_90b,
    "seamless-m4t-medium": seamless_m4t_medium,
    "zamba2-1.2b": zamba2_1_2b,
    "xlstm-1.3b": xlstm_1_3b,
    "deepseek-v2-236b": deepseek_v2_236b,
    "mixtral-8x7b": mixtral_8x7b,
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str) -> ModelConfig:
    return _MODULES[name].CONFIG


def get_reduced_config(name: str) -> ModelConfig:
    return _MODULES[name].REDUCED

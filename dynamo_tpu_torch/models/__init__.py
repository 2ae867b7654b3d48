"""Model family of the port: Llama-family decoders (dense, qwen2 biases,
sliding windows, sinks, mixtral and gpt-oss MoE, M-RoPE) over the paged
KV pool, with int8 weights; the vision towers (`qwen_vl`, `vision`) and
their checkpoint loaders (`vlm`)."""

from .config import (
    CONFIGS,
    GPT_OSS_20B,
    LLAMA_3_1_8B,
    LLAMA_3_2_1B,
    ModelConfig,
    tiny_config,
    tiny_moe_config,
)
from .llama import KVCache, Llama, init_params, params_from_jax
from .quantization import quantize_params, random_int8_params

__all__ = [
    "CONFIGS",
    "GPT_OSS_20B",
    "KVCache",
    "LLAMA_3_1_8B",
    "LLAMA_3_2_1B",
    "Llama",
    "ModelConfig",
    "init_params",
    "params_from_jax",
    "quantize_params",
    "random_int8_params",
    "tiny_config",
    "tiny_moe_config",
]

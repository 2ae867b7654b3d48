"""Model family of the port: dense Llama over the paged KV pool."""

from .config import CONFIGS, LLAMA_3_1_8B, LLAMA_3_2_1B, ModelConfig, tiny_config
from .llama import KVCache, Llama, init_params, params_from_jax

__all__ = [
    "CONFIGS",
    "KVCache",
    "LLAMA_3_1_8B",
    "LLAMA_3_2_1B",
    "Llama",
    "ModelConfig",
    "init_params",
    "params_from_jax",
    "tiny_config",
]

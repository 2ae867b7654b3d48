"""Tensor ops of the port: norm, rotary (with M-RoPE), paged attention,
the MoE grouped GEMM (`moe.py`) and the vision towers' segment attention
(`vision_attention.py`) (CUDA kernels on the card, plain PyTorch on the
CPU) and sampling."""

from .norm import rms_norm
from .paged_attention import (
    decode_attention,
    gather_kv,
    prefill_attention,
    write_kv_pages,
)
from .rotary import apply_rope, rope_attention_scale, rope_frequencies
from .sampling import (
    SamplingParams,
    apply_penalties,
    compute_logprobs,
    sample_tokens,
    top_logprobs,
)

__all__ = [
    "SamplingParams",
    "apply_penalties",
    "apply_rope",
    "compute_logprobs",
    "decode_attention",
    "gather_kv",
    "prefill_attention",
    "rms_norm",
    "rope_attention_scale",
    "rope_frequencies",
    "sample_tokens",
    "top_logprobs",
    "write_kv_pages",
]

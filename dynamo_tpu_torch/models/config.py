"""Model configuration (a copy of the JAX package's, with no JAX in it).

The reference framework delegates the model to external engines (vLLM /
SGLang / TRT-LLM); the TPU build runs its own models, so the config lives
here.  Shapes follow the HF `LlamaConfig` field names so checkpoints load
without a translation table (reference consumes the same HF config when
building its ModelDeploymentCard, reference lib/llm/src/model_card.rs:118).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, replace
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters for a decoder-only transformer.

    Covers the Llama family (Llama 2/3, TinyLlama, Mistral-style GQA) and
    Mixtral/DeepSeek-style MoE variants via ``num_experts``.
    """

    vocab_size: int = 32000
    hidden_size: int = 2048
    intermediate_size: int = 5632
    num_hidden_layers: int = 22
    num_attention_heads: int = 32
    num_key_value_heads: int = 4
    head_dim: Optional[int] = None
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    rope_scaling: Optional[dict] = None
    # Qwen2-VL multimodal rope: head_dim//2 rotary frequencies split
    # into (temporal, height, width) sections; text tokens carry equal
    # ids on all three streams (ops.apply_mrope).  None = standard rope.
    mrope_section: Optional[tuple] = None
    tie_word_embeddings: bool = False
    attention_bias: bool = False
    # gpt-oss biases o_proj too (qwen2 biases only q/k/v)
    attention_out_bias: bool = False
    # sliding-window attention (Mistral/GPT-OSS family): tokens attend to
    # at most the last `sliding_window` positions.  `layer_types` (HF
    # convention: "sliding_attention" / "full_attention" per layer) mixes
    # windowed and full layers; None = every layer windowed.
    sliding_window: Optional[int] = None
    layer_types: Optional[tuple] = None
    # learnable per-head attention-sink logits (GPT-OSS): an extra column
    # in the softmax denominator that soaks up attention mass
    attention_sinks: bool = False
    # MoE (0 = dense)
    num_experts: int = 0
    num_experts_per_tok: int = 2
    moe_intermediate_size: Optional[int] = None
    # "ragged": dropless sort + ragged_dot (default — deterministic per
    #   token, exactly O(T*k) FFN rows; MaxText's sparse-matmul pattern)
    # "capacity": GShard capacity-bounded one-hot dispatch (einsum
    #   all-to-all under GSPMD; tokens past capacity drop)
    # "dense": all experts compute all tokens (equality oracle)
    moe_impl: str = "ragged"
    # capacity-dispatch headroom: C = ceil(G*k*factor/E);
    # <= 0 selects the dense all-experts path (equality oracle / tiny tests)
    moe_capacity_factor: float = 1.25
    # dispatch group size: tokens are dispatched within groups of this many
    # so the one-hot dispatch tensor stays O(T*G), not O(T^2)
    moe_group_size: int = 256
    # expert activation: "silu" (mixtral-style silu(gate)*up) or
    # "gpt_oss_glu" (clamped gate*sigmoid(1.702*gate) * (up+1) — HF
    # GptOssExperts with limit 7.0); moe_bias adds router + per-expert
    # gate/up/down biases (gpt-oss carries all four)
    moe_act: str = "silu"
    moe_bias: bool = False
    # identity
    model_type: str = "llama"
    name: str = "llama"
    dtype: str = "bfloat16"

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads

    @property
    def num_kv_groups(self) -> int:
        return self.num_attention_heads // self.num_key_value_heads

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def layer_windows(self) -> list:
        """Per-layer attention window (0 = full attention)."""
        L = self.num_hidden_layers
        if not self.sliding_window:
            return [0] * L
        if self.layer_types is None:
            return [self.sliding_window] * L
        if len(self.layer_types) != L:
            raise ValueError(
                f"layer_types has {len(self.layer_types)} entries for "
                f"{L} layers"
            )
        return [
            self.sliding_window if "sliding" in t else 0
            for t in self.layer_types
        ]

    def with_depth(self, layers: int) -> "ModelConfig":
        """This config cut to its first `layers` layers at full width, its
        per-layer attention types cut with it."""
        types = self.layer_types
        return replace(self, num_hidden_layers=layers,
                       layer_types=None if types is None else tuple(types[:layers]))

    def num_params(self) -> int:
        """Approximate parameter count (for memory planning)."""
        h, v, l = self.hidden_size, self.vocab_size, self.num_hidden_layers
        hd = self.head_dim_
        attn = h * (self.num_attention_heads * hd) + 2 * h * (
            self.num_key_value_heads * hd
        ) + (self.num_attention_heads * hd) * h
        if self.is_moe:
            ffn_inter = self.moe_intermediate_size or self.intermediate_size
            mlp = self.num_experts * 3 * h * ffn_inter + h * self.num_experts
        else:
            mlp = 3 * h * self.intermediate_size
        emb = v * h * (1 if self.tie_word_embeddings else 2)
        return l * (attn + mlp + 2 * h) + emb + h

    @staticmethod
    def from_hf_config(d: dict, name: str = "") -> "ModelConfig":
        """Build from a HF ``config.json`` dict (llama/mistral/mixtral/qwen2)."""
        num_experts = d.get("num_local_experts", d.get("n_routed_experts", 0)) or 0
        return ModelConfig(
            vocab_size=d["vocab_size"],
            hidden_size=d["hidden_size"],
            intermediate_size=d.get("intermediate_size", 4 * d["hidden_size"]),
            num_hidden_layers=d["num_hidden_layers"],
            num_attention_heads=d["num_attention_heads"],
            num_key_value_heads=d.get(
                "num_key_value_heads", d["num_attention_heads"]
            ),
            head_dim=d.get("head_dim"),
            max_position_embeddings=d.get("max_position_embeddings", 4096),
            rms_norm_eps=d.get("rms_norm_eps", 1e-5),
            rope_theta=d.get("rope_theta", 10000.0),
            rope_scaling=d.get("rope_scaling"),
            # Qwen2-VL: rope_scaling {"type"|"rope_type": "mrope",
            # "mrope_section": [t, h, w]} (HF Qwen2VLConfig)
            mrope_section=(
                tuple(d["rope_scaling"]["mrope_section"])
                if (d.get("rope_scaling") or {}).get(
                    "rope_type", (d.get("rope_scaling") or {}).get("type")
                ) in ("mrope", "default") and
                (d.get("rope_scaling") or {}).get("mrope_section")
                else None
            ),
            tie_word_embeddings=d.get("tie_word_embeddings", False),
            # HF Qwen2Config has no attention_bias field — its attention
            # hardcodes qkv bias on (o_proj off); mirror that default
            attention_bias=(attn_bias := d.get(
                "attention_bias",
                d.get("model_type") in ("qwen2", "qwen2_vl",
                                        "qwen2_vl_text", "qwen2_5_vl",
                                        "qwen2_5_vl_text", "gpt_oss"),
            )),
            # gpt-oss biases o_proj too — ONE resolution of
            # attention_bias drives both fields so they cannot split
            attention_out_bias=(
                d.get("model_type") == "gpt_oss" and attn_bias
            ),
            num_experts=num_experts,
            num_experts_per_tok=d.get("num_experts_per_tok", 2),
            moe_intermediate_size=d.get("moe_intermediate_size"),
            moe_act=("gpt_oss_glu" if d.get("model_type") == "gpt_oss"
                     else "silu"),
            moe_bias=d.get("model_type") == "gpt_oss",
            # Qwen2.5 ships sliding_window=131072 with
            # use_sliding_window=false — HF only engages the window when
            # the flag is on (absent = on, the Mistral convention)
            sliding_window=(d.get("sliding_window")
                            if d.get("use_sliding_window", True) else None),
            layer_types=(tuple(d["layer_types"])
                         if d.get("layer_types") else None),
            # GPT-OSS attention always carries learnable sinks (HF
            # GptOssAttention `sinks` parameter)
            attention_sinks=d.get(
                "attention_sinks", d.get("model_type") == "gpt_oss"
            ),
            model_type=d.get("model_type", "llama"),
            name=name or d.get("_name_or_path", "llama"),
        )

    @staticmethod
    def from_pretrained(path: str) -> "ModelConfig":
        with open(os.path.join(path, "config.json")) as f:
            return ModelConfig.from_hf_config(json.load(f), name=os.path.basename(path))


# -- canned configs ---------------------------------------------------------- #

def tiny_config(**over) -> ModelConfig:
    """Tiny model for tests (runs on the CPU in milliseconds)."""
    base = dict(
        vocab_size=256,
        hidden_size=64,
        intermediate_size=128,
        num_hidden_layers=2,
        num_attention_heads=4,
        num_key_value_heads=2,
        max_position_embeddings=512,
        name="tiny-llama-test",
    )
    base.update(over)
    return ModelConfig(**base)


def tiny_moe_config(**over) -> ModelConfig:
    base = dict(
        vocab_size=256,
        hidden_size=64,
        intermediate_size=128,
        num_hidden_layers=2,
        num_attention_heads=4,
        num_key_value_heads=2,
        max_position_embeddings=512,
        num_experts=4,
        num_experts_per_tok=2,
        name="tiny-moe-test",
    )
    base.update(over)
    return ModelConfig(**base)


LLAMA_3_2_1B = ModelConfig(
    vocab_size=128256,
    hidden_size=2048,
    intermediate_size=8192,
    num_hidden_layers=16,
    num_attention_heads=32,
    num_key_value_heads=8,
    head_dim=64,
    max_position_embeddings=131072,
    rms_norm_eps=1e-5,
    rope_theta=500000.0,
    rope_scaling={
        "factor": 32.0,
        "high_freq_factor": 4.0,
        "low_freq_factor": 1.0,
        "original_max_position_embeddings": 8192,
        "rope_type": "llama3",
    },
    tie_word_embeddings=True,
    name="llama-3.2-1b",
)

LLAMA_3_1_8B = ModelConfig(
    vocab_size=128256,
    hidden_size=4096,
    intermediate_size=14336,
    num_hidden_layers=32,
    num_attention_heads=32,
    num_key_value_heads=8,
    max_position_embeddings=131072,
    rms_norm_eps=1e-5,
    rope_theta=500000.0,
    rope_scaling={
        "factor": 8.0,
        "high_freq_factor": 4.0,
        "low_freq_factor": 1.0,
        "original_max_position_embeddings": 8192,
        "rope_type": "llama3",
    },
    name="llama-3.1-8b",
)

LLAMA_3_70B = ModelConfig(
    vocab_size=128256,
    hidden_size=8192,
    intermediate_size=28672,
    num_hidden_layers=80,
    num_attention_heads=64,
    num_key_value_heads=8,
    max_position_embeddings=131072,
    rms_norm_eps=1e-5,
    rope_theta=500000.0,
    name="llama-3-70b",
)

MIXTRAL_8X7B = ModelConfig(
    vocab_size=32000,
    hidden_size=4096,
    intermediate_size=14336,
    num_hidden_layers=32,
    num_attention_heads=32,
    num_key_value_heads=8,
    max_position_embeddings=32768,
    rms_norm_eps=1e-5,
    rope_theta=1000000.0,
    num_experts=8,
    num_experts_per_tok=2,
    model_type="mixtral",
    name="mixtral-8x7b",
)

MISTRAL_7B = ModelConfig(
    vocab_size=32000,
    hidden_size=4096,
    intermediate_size=14336,
    num_hidden_layers=32,
    num_attention_heads=32,
    num_key_value_heads=8,
    max_position_embeddings=32768,
    rms_norm_eps=1e-5,
    rope_theta=10000.0,
    sliding_window=4096,
    model_type="mistral",
    name="mistral-7b",
)

QWEN2_5_7B = ModelConfig(
    vocab_size=152064,
    hidden_size=3584,
    intermediate_size=18944,
    num_hidden_layers=28,
    num_attention_heads=28,
    num_key_value_heads=4,
    max_position_embeddings=32768,
    rms_norm_eps=1e-6,
    rope_theta=1000000.0,
    attention_bias=True,
    model_type="qwen2",
    name="qwen2.5-7b",
)

QWEN2_5_0_5B = ModelConfig(
    vocab_size=151936,
    hidden_size=896,
    intermediate_size=4864,
    num_hidden_layers=24,
    num_attention_heads=14,
    num_key_value_heads=2,
    max_position_embeddings=32768,
    rms_norm_eps=1e-6,
    rope_theta=1000000.0,
    attention_bias=True,
    tie_word_embeddings=True,
    model_type="qwen2",
    name="qwen2.5-0.5b",
)

QWEN2_5_VL_7B = ModelConfig(
    # Qwen/Qwen2.5-VL-7B-Instruct config.json (the text stack): qwen2
    # biases, 28 q / 4 kv heads (a group of 7), M-RoPE over sections
    # [16, 24, 24] of the 64 rotary frequencies, untied head
    vocab_size=152064,
    hidden_size=3584,
    intermediate_size=18944,
    num_hidden_layers=28,
    num_attention_heads=28,
    num_key_value_heads=4,
    max_position_embeddings=128000,
    rms_norm_eps=1e-6,
    rope_theta=1000000.0,
    rope_scaling={"type": "mrope", "mrope_section": [16, 24, 24]},
    mrope_section=(16, 24, 24),
    attention_bias=True,
    model_type="qwen2_5_vl",
    name="qwen2.5-vl-7b",
)

# The same config.json's `vision_config` (the keys
# `qwen_vl.Qwen2VLVisionConfig.from_hf_config` reads) and its media token
# ids, for the canned multimodal models
VISION_CONFIGS = {
    "qwen2.5-vl-7b": {
        "depth": 32, "hidden_size": 1280, "intermediate_size": 3420,
        "num_heads": 16, "in_chans": 3, "patch_size": 14,
        "temporal_patch_size": 2, "spatial_merge_size": 2,
        "window_size": 112, "fullatt_block_indexes": [7, 15, 23, 31],
        "tokens_per_second": 2, "out_hidden_size": 3584,
    },
}
MEDIA_TOKENS = {
    "qwen2.5-vl-7b": {"image_token_id": 151655, "video_token_id": 151656,
                      "vision_start_token_id": 151652,
                      "vision_end_token_id": 151653},
}

GPT_OSS_20B = ModelConfig(
    # openai/gpt-oss-20b (HF GptOssConfig): 24-layer MoE, 32 experts
    # top-4, alternating sliding/full attention, learnable sinks,
    # biased router + clamped-GLU experts, o_proj bias
    vocab_size=201088,
    hidden_size=2880,
    intermediate_size=2880,
    num_hidden_layers=24,
    num_attention_heads=64,
    num_key_value_heads=8,
    head_dim=64,
    max_position_embeddings=131072,
    rms_norm_eps=1e-5,
    rope_theta=150000.0,
    rope_scaling={"rope_type": "yarn", "factor": 32.0,
                  "beta_fast": 32.0, "beta_slow": 1.0,
                  "original_max_position_embeddings": 4096,
                  "truncate": False},
    attention_bias=True,
    attention_out_bias=True,
    attention_sinks=True,
    sliding_window=128,
    layer_types=tuple(
        "sliding_attention" if i % 2 == 0 else "full_attention"
        for i in range(24)
    ),
    num_experts=32,
    num_experts_per_tok=4,
    moe_act="gpt_oss_glu",
    moe_bias=True,
    model_type="gpt_oss",
    name="gpt-oss-20b",
)

CONFIGS = {
    c.name: c
    for c in [LLAMA_3_2_1B, LLAMA_3_1_8B, LLAMA_3_70B, MIXTRAL_8X7B,
              MISTRAL_7B, QWEN2_5_7B, QWEN2_5_0_5B, QWEN2_5_VL_7B,
              GPT_OSS_20B]
}

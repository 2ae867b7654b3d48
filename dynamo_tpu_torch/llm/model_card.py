"""ModelDeploymentCard — the unit of model discovery.

The port's copy of the JAX package's `llm/model_card.py` (same fields and
dict form, so JAX and port processes read each other's cards).  A worker builds a card describing what it serves and publishes it to the
control plane under its lease; frontends watch the prefix and build a
serving pipeline per card (reference:
lib/llm/src/model_card.rs:118 `ModelDeploymentCard`,
local_model.rs:307 `attach`, discovery/watcher.rs:49 `ModelWatcher`).
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional

MODEL_ROOT = "/models"


@dataclass
class RuntimeConfig:
    """Engine capacity hints the router/planner can use (reference
    model_card.rs ModelRuntimeConfig)."""

    total_kv_blocks: int = 0
    max_num_seqs: int = 0
    max_num_batched_tokens: int = 0
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ModelDeploymentCard:
    name: str
    namespace: str = "dynamo"
    component: str = "backend"
    endpoint: str = "generate"
    # what the model speaks
    model_type: str = "chat,completions"  # csv of chat|completions|embedding|tensor
    model_input: str = "tokens"  # "text" | "tokens"
    context_length: int = 4096
    kv_cache_block_size: int = 16
    migration_limit: int = 3
    # retry pacing between migration attempts that made NO progress
    # (capped exponential + jitter; a post-progress failure is a fresh
    # incident and retries immediately).  0 disables the backoff.
    migration_backoff_ms: int = 50
    migration_backoff_max_ms: int = 2000
    # latency SLO class for this model (frontend/slo.py live windows +
    # the planner's knee estimation score against these; worker CLI
    # --slo-ttft-ms/--slo-itl-ms set them, DYN_TPU_SLO_* env overrides
    # win at the frontend; 0 = use the frontend default class)
    slo_ttft_ms: float = 0.0
    slo_itl_ms: float = 0.0
    # default priority class for requests that don't set one
    # ("interactive" | "batch"; worker CLI --priority-class sets it,
    # per-request `priority` / `nvext.priority` overrides win)
    priority_class: str = "interactive"
    # tokenization (None → frontend loads from checkpoint_path)
    checkpoint_path: Optional[str] = None
    tokenizer_json: Optional[str] = None  # inline tokenizer.json contents
    chat_template: Optional[str] = None
    eos_token_ids: List[int] = field(default_factory=list)
    bos_token_id: Optional[int] = None
    runtime_config: RuntimeConfig = field(default_factory=RuntimeConfig)
    # disaggregation role: "both" | "prefill" | "decode"
    disagg_role: str = "both"
    # output parsers (dynamo_tpu.parsers registry names; "" = passthrough)
    reasoning_parser: str = ""
    tool_call_parser: str = ""
    # multimodal: non-empty image_token → the worker accepts image_url
    # content parts; the preprocessor expands the placeholder to
    # image_patches tokens and ships processed pixels on the wire
    image_token: str = ""
    image_token_id: Optional[int] = None
    image_patches: int = 0
    image_size: int = 0
    # multimodal architecture: "clip" (fixed-resolution tower,
    # image_patches per image) or "qwen2_vl" (dynamic resolution +
    # M-RoPE; per-image token counts come from smart-resized grids, and
    # video_url parts are accepted).  mm_config carries the vision
    # geometry the preprocessor needs (patch/merge/temporal sizes,
    # pixel budget) without shipping tower weights
    mm_arch: str = "clip"
    mm_config: Dict[str, Any] = field(default_factory=dict)
    user_data: Dict[str, Any] = field(default_factory=dict)

    @property
    def types(self) -> List[str]:
        return [t.strip() for t in self.model_type.split(",") if t.strip()]

    def supports(self, kind: str) -> bool:
        return kind in self.types

    def slug(self) -> str:
        return self.name.replace("/", "--")

    def card_path(self, instance_id: int) -> str:
        """Discovery key: one card per serving instance, lease-scoped."""
        return f"{MODEL_ROOT}/{self.namespace}/{self.slug()}/{instance_id}"

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "ModelDeploymentCard":
        d = dict(d)
        rc = d.get("runtime_config") or {}
        d["runtime_config"] = RuntimeConfig(**rc) if isinstance(rc, dict) else rc
        return ModelDeploymentCard(**d)

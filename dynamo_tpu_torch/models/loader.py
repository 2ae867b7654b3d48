"""HF checkpoint loader: safetensors → the port's `Llama`.

The port's copy of the dense part of the JAX package's `models/loader.py`:
the same weight names and the same layout (projections input-major, so
``x @ w`` needs no transpose), read with the port's numpy safetensors
reader.  Where the JAX loader stacks every layer into one array, this one
copies each layer's tensor straight into its parameter on the target
device, so a full-size checkpoint never holds a stacked f32 copy in host
memory.  Attention biases, sinks, MoE and MXFP4 checkpoints are refused:
the port's model does not take them yet.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
import torch

from .config import ModelConfig
from .llama import _LAYER_KEYS, Llama, _check_supported
from .safetensors_np import safe_open

# the port's per-layer parameter → HF tensor name under model.layers.{i}.
_HF_NAMES = {
    "wq": "self_attn.q_proj.weight",
    "wk": "self_attn.k_proj.weight",
    "wv": "self_attn.v_proj.weight",
    "wo": "self_attn.o_proj.weight",
    "attn_norm": "input_layernorm.weight",
    "mlp_norm": "post_attention_layernorm.weight",
    "w_gate": "mlp.gate_proj.weight",
    "w_up": "mlp.up_proj.weight",
    "w_down": "mlp.down_proj.weight",
}
assert set(_HF_NAMES) == set(_LAYER_KEYS)


def _index(path: str) -> Dict[str, str]:
    """weight name → shard file."""
    idx_path = os.path.join(path, "model.safetensors.index.json")
    if os.path.exists(idx_path):
        with open(idx_path) as f:
            return json.load(f)["weight_map"]
    single = os.path.join(path, "model.safetensors")
    if not os.path.exists(single):
        raise FileNotFoundError(f"no safetensors checkpoint in {path}")
    with safe_open(single) as f:
        return {k: "model.safetensors" for k in f.keys()}


class _ShardReader:
    def __init__(self, path: str):
        self.path = path
        self.weight_map = _index(path)
        self._open: Dict[str, object] = {}

    def get(self, name: str) -> np.ndarray:
        shard = self.weight_map[name]
        if shard not in self._open:
            self._open[shard] = safe_open(os.path.join(self.path, shard))
        return self._open[shard].get_tensor(name)

    def has(self, name: str) -> bool:
        return name in self.weight_map


def _to(dst: torch.Tensor, a: np.ndarray) -> None:
    """Copy a host array into a parameter: one rounding to its dtype."""
    dst.copy_(torch.from_numpy(np.ascontiguousarray(a)).to(dst.dtype))


@torch.no_grad()
def load_params(path: str, cfg: ModelConfig, dtype=torch.bfloat16,
                prefix: str = "", reader=None, device=None) -> Llama:
    """HF weights from the checkpoint directory `path` into a `Llama` on
    `device` (CUDA unless the caller passes ``"cpu"``).  `prefix`
    namespaces every tensor name (VLM checkpoints nest the LLM under
    "language_model."); `reader` reuses an open `_ShardReader`."""
    _check_supported(cfg)
    r = reader or _ShardReader(path)
    if r.has(prefix + "model.layers.0.self_attn.q_proj.bias"):
        raise ValueError(
            "checkpoint has self_attn.*_proj.bias tensors but the config "
            "does not declare attention_bias — refusing to silently drop "
            "them")
    model = Llama(cfg, dtype=dtype, device=device)
    for i, layer in enumerate(model.layers):
        for key, hf in _HF_NAMES.items():
            w = r.get(f"{prefix}model.layers.{i}.{hf}")
            _to(getattr(layer, key), w if key.endswith("norm") else w.T)
    embed = r.get(prefix + "model.embed_tokens.weight")
    _to(model.embed, embed)
    _to(model.final_norm, r.get(prefix + "model.norm.weight"))
    if model.lm_head is not None:
        head = (r.get(prefix + "lm_head.weight") if r.has(prefix + "lm_head.weight")
                else embed)
        _to(model.lm_head, head.T)
    return model

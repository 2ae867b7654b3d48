"""HF checkpoint loader: safetensors → the port's `Llama`.

The port's copy of the JAX package's `models/loader.py`: the same weight
names, branches and refusals (llama/mistral, qwen2 q/k/v biases, the
gpt-oss o_proj bias, sinks, biased router and interleaved expert stacks,
MXFP4 expert blocks, mixtral's per-expert ``block_sparse_moe`` tensors)
and the same layout (projections input-major, so ``x @ w`` needs no
transpose), read with the port's numpy safetensors reader.  Where the
JAX loader stacks every layer into one array, this one copies each
layer's tensors straight into its parameters on the target device (MXFP4
experts dequantized one layer at a time), so a full-size checkpoint never
builds a stacked host copy.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
import torch

from .config import ModelConfig
from .llama import Llama, _check_supported
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
# 1-D or stacked tensors copied as they are (no transpose)
_HF_PLAIN = {
    "bq": "self_attn.q_proj.bias",
    "bk": "self_attn.k_proj.bias",
    "bv": "self_attn.v_proj.bias",
    "bo": "self_attn.o_proj.bias",
    "sinks": "self_attn.sinks",
}


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


def _check_checkpoint(r: _ShardReader, cfg: ModelConfig, prefix: str) -> None:
    """The JAX loader's refusals: the config and the checkpoint must agree
    on biases and sinks (a mismatch is a load error, never a silent
    drop)."""
    has_bias = r.has(prefix + "model.layers.0.self_attn.q_proj.bias")
    if cfg.attention_bias and not has_bias:
        raise ValueError(
            "config declares attention_bias but the checkpoint has "
            "no self_attn.*_proj.bias tensors")
    if has_bias and not cfg.attention_bias:
        raise ValueError(
            "checkpoint has self_attn.*_proj.bias tensors but the config "
            "does not declare attention_bias — refusing to silently drop "
            "them")
    if cfg.attention_sinks and not r.has(prefix + "model.layers.0.self_attn.sinks"):
        raise ValueError(
            "config declares attention_sinks but the checkpoint has "
            "no self_attn.sinks tensors")


def _load_gpt_oss_experts(r: _ShardReader, layer, p: str, mxfp4: bool) -> None:
    """gpt-oss layout for one layer: the router transposed, expert tensors
    with INTERLEAVED gate/up columns (HF GptOssExperts: gate = [..., ::2]),
    per-expert biases; MXFP4 blocks+scales dequantized here, one layer at
    a time, bit-equal to HF `convert_moe_packed_tensors`."""
    def proj(name):
        if not mxfp4:
            return r.get(p + f"mlp.experts.{name}")
        from .mxfp4 import dequant_mxfp4

        return dequant_mxfp4(r.get(p + f"mlp.experts.{name}_blocks"),
                             r.get(p + f"mlp.experts.{name}_scales"))

    gu = proj("gate_up_proj")  # [E, h, 2f]
    gub = r.get(p + "mlp.experts.gate_up_proj_bias")  # [E, 2f]
    _to(layer.router, r.get(p + "mlp.router.weight").T)  # [E, h] → [h, E]
    _to(layer.router_b, r.get(p + "mlp.router.bias"))
    _to(layer.w_gate, gu[..., ::2])
    _to(layer.w_up, gu[..., 1::2])
    _to(layer.b_gate, gub[..., ::2])
    _to(layer.b_up, gub[..., 1::2])
    _to(layer.w_down, proj("down_proj"))
    _to(layer.b_down, r.get(p + "mlp.experts.down_proj_bias"))


def _load_mixtral_experts(r: _ShardReader, layer, p: str, E: int) -> None:
    """Mixtral: ``block_sparse_moe.gate`` is the router; expert e's w1 /
    w3 / w2 are its gate / up / down, each copied into its slot."""
    _to(layer.router, r.get(p + "block_sparse_moe.gate.weight").T)
    for key, sub in (("w_gate", "w1"), ("w_up", "w3"), ("w_down", "w2")):
        dst = getattr(layer, key)
        for e in range(E):
            _to(dst[e], r.get(p + f"block_sparse_moe.experts.{e}.{sub}.weight").T)


@torch.no_grad()
def load_params(path: str, cfg: ModelConfig, dtype=torch.bfloat16,
                prefix: str = "", reader=None, device=None) -> Llama:
    """HF weights from the checkpoint directory `path` into a `Llama` on
    `device` (CUDA unless the caller passes ``"cpu"``).  `prefix`
    namespaces every tensor name (VLM checkpoints nest the LLM under
    "language_model."); `reader` reuses an open `_ShardReader`."""
    _check_supported(cfg)
    r = reader or _ShardReader(path)
    _check_checkpoint(r, cfg, prefix)
    model = Llama(cfg, dtype=dtype, device=device)
    mxfp4 = r.has(prefix + "model.layers.0.mlp.experts.gate_up_proj_blocks")
    gpt_oss = cfg.moe_bias and (
        mxfp4 or r.has(prefix + "model.layers.0.mlp.experts.gate_up_proj"))
    for i, layer in enumerate(model.layers):
        p = f"{prefix}model.layers.{i}."
        for key, hf in _HF_NAMES.items():
            if cfg.is_moe and key in ("w_gate", "w_up", "w_down"):
                continue
            w = r.get(p + hf)
            _to(getattr(layer, key), w if key.endswith("norm") else w.T)
        for key, hf in _HF_PLAIN.items():
            if getattr(layer, key) is not None:
                _to(getattr(layer, key), r.get(p + hf))
        if gpt_oss:
            _load_gpt_oss_experts(r, layer, p, mxfp4)
        elif cfg.is_moe:
            _load_mixtral_experts(r, layer, p, cfg.num_experts)
    embed = r.get(prefix + "model.embed_tokens.weight")
    _to(model.embed, embed)
    _to(model.final_norm, r.get(prefix + "model.norm.weight"))
    if model.lm_head is not None:
        head = (r.get(prefix + "lm_head.weight") if r.has(prefix + "lm_head.weight")
                else embed)
        _to(model.lm_head, head.T)
    return model

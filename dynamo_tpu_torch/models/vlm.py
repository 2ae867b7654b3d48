"""Vision-language checkpoints → the port's towers and `Llama` (the JAX
package's `models/vlm.py`, on the port's safetensors reader).

- LLaVA: ``vision_tower.vision_model.*`` (CLIP ViT: conv patch embedding,
  class token, pre/post LayerNorms, q/k/v/out projections with biases,
  fc1/fc2) and ``multi_modal_projector.linear_{1,2}`` → `models.vision`;
  ``language_model.model.*`` → the llama loader under a prefix.
- Qwen2-VL / 2.5-VL: ``visual.*`` + ``model.*`` (the published layout)
  or ``model.visual.*`` + ``model.language_model.*`` (re-nested) →
  `models.qwen_vl` and the llama loader.

Both loaders return (llm, llm_cfg, tower, vision_cfg) and refuse what the
JAX loaders refuse: a `vision_feature_select_strategy` other than
"default", a `vision_feature_layer` that is not one int in range, a
qwen-vl config without `mrope_section`, a tower output that is not the
LLM's width, a checkpoint without a tower.
"""

from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np
import torch

from .config import ModelConfig
from .loader import _ShardReader, load_params
from .qwen_vl import Qwen2VLVisionConfig, qwen_vl_tower
from .vision import VisionConfig, clip_tower, tree_into

VT = "vision_tower.vision_model."
LAYER = VT + "encoder.layers.{i}."


def vision_config_from_hf(d: dict, out_hidden: int, projector_hidden: int,
                          feature_layer: int = -2) -> VisionConfig:
    """An HF CLIP `vision_config` dict as a `VisionConfig`;
    `feature_layer` is the top-level `vision_feature_layer` (llava's -2:
    the second-to-last hidden states, no post-LayerNorm)."""
    L = d.get("num_hidden_layers", 24)
    if not isinstance(feature_layer, int) or isinstance(feature_layer, bool):
        raise ValueError(f"vision_feature_layer={feature_layer!r} unsupported "
                         "(multi-layer selects are not implemented)")
    if feature_layer >= 0:
        if feature_layer > L:
            raise ValueError(f"vision_feature_layer={feature_layer} > {L} layers")
        feature_layer = feature_layer - (L + 1)
    elif feature_layer < -(L + 1):
        raise ValueError(f"vision_feature_layer={feature_layer} out of range "
                         f"for {L} layers")
    return VisionConfig(
        image_size=d.get("image_size", 336),
        patch_size=d.get("patch_size", 14),
        hidden_size=d.get("hidden_size", 1024),
        intermediate_size=d.get("intermediate_size", 4096),
        num_hidden_layers=L,
        num_attention_heads=d.get("num_attention_heads", 16),
        out_hidden_size=out_hidden,
        layer_norm_eps=d.get("layer_norm_eps", 1e-5),
        attention_bias=True, use_cls_token=True, pre_layernorm=True,
        projector_hidden=projector_hidden,
        feature_layer=feature_layer,
        hidden_act=d.get("hidden_act", "quick_gelu"),
    )


def _stack(r: _ShardReader, L: int, fmt: str, transpose: bool = True) -> np.ndarray:
    return np.stack([(r.get(fmt.format(i=i)).T if transpose else r.get(fmt.format(i=i)))
                     for i in range(L)]).astype(np.float32)


def load_vision_params(path: str, vcfg: VisionConfig, reader=None,
                       device=None):
    """LLaVA / CLIP tower weights → an f32 `vision.clip_tower`."""
    r = reader or _ShardReader(path)
    L, p = vcfg.num_hidden_layers, vcfg.patch_size
    conv = r.get(VT + "embeddings.patch_embedding.weight")  # [h, 3, p, p]
    names = {"ln1_scale": ("layer_norm1.weight", False),
             "ln1_bias": ("layer_norm1.bias", False),
             "wq": ("self_attn.q_proj.weight", True), "bq": ("self_attn.q_proj.bias", False),
             "wk": ("self_attn.k_proj.weight", True), "bk": ("self_attn.k_proj.bias", False),
             "wv": ("self_attn.v_proj.weight", True), "bv": ("self_attn.v_proj.bias", False),
             "wo": ("self_attn.out_proj.weight", True), "bo": ("self_attn.out_proj.bias", False),
             "ln2_scale": ("layer_norm2.weight", False),
             "ln2_bias": ("layer_norm2.bias", False),
             "w1": ("mlp.fc1.weight", True), "b1": ("mlp.fc1.bias", False),
             "w2": ("mlp.fc2.weight", True), "b2": ("mlp.fc2.bias", False)}
    tree = {
        # patchify order (ph, pw, c): conv [h, c, ph, pw] → [(ph, pw, c), h]
        "patch_proj": conv.transpose(2, 3, 1, 0).reshape(p * p * 3, -1),
        "pos_embed": r.get(VT + "embeddings.position_embedding.weight"),
        "cls_token": r.get(VT + "embeddings.class_embedding").reshape(-1),
        "pre_ln_scale": r.get(VT + "pre_layrnorm.weight"),
        "pre_ln_bias": r.get(VT + "pre_layrnorm.bias"),
        "post_ln_scale": r.get(VT + "post_layernorm.weight"),
        "post_ln_bias": r.get(VT + "post_layernorm.bias"),
        "proj": r.get("multi_modal_projector.linear_1.weight").T,
        "proj_b1": r.get("multi_modal_projector.linear_1.bias"),
        "proj2": r.get("multi_modal_projector.linear_2.weight").T,
        "proj_b2": r.get("multi_modal_projector.linear_2.bias"),
        "layers": {k: _stack(r, L, LAYER + hf, t) for k, (hf, t) in names.items()},
    }
    return tree_into(clip_tower(vcfg, torch.float32, device), tree)


def _hf_config(path: str) -> Tuple[dict, ModelConfig]:
    with open(os.path.join(path, "config.json")) as f:
        hf = json.load(f)
    text = hf.get("text_config") or hf
    return hf, ModelConfig.from_hf_config(
        text, name=hf.get("_name_or_path") or os.path.basename(path))


def load_vlm(path: str, dtype=torch.bfloat16, device=None) -> Tuple:
    """A LLaVA-layout checkpoint directory → (llm, llm_cfg, tower,
    vision_cfg); the tower in f32."""
    hf, llm_cfg = _hf_config(path)
    strategy = hf.get("vision_feature_select_strategy", "default")
    if strategy != "default":
        raise ValueError(
            f"vision_feature_select_strategy={strategy!r} is not supported "
            "(only 'default': the class token dropped from the patch run)")
    r = _ShardReader(path)
    if not r.has(VT + "embeddings.patch_embedding.weight"):
        raise ValueError("no vision tower found in checkpoint")
    projector_hidden = r.get("multi_modal_projector.linear_1.bias").shape[0]
    vcfg = vision_config_from_hf(hf.get("vision_config") or {},
                                 out_hidden=llm_cfg.hidden_size,
                                 projector_hidden=projector_hidden,
                                 feature_layer=hf.get("vision_feature_layer", -2))
    tower = load_vision_params(path, vcfg, reader=r, device=device)
    llm = load_params(path, llm_cfg, dtype=dtype, prefix="language_model.",
                      reader=r, device=device)
    return llm, llm_cfg, tower, vcfg


def load_qwen_vl_vision_params(path: str, vcfg: Qwen2VLVisionConfig,
                               reader=None, prefix: str = "visual.",
                               device=None):
    """Qwen2-VL / 2.5-VL tower weights → an f32 `qwen_vl.qwen_vl_tower`."""
    r = reader or _ShardReader(path)
    B = prefix + "blocks.{i}."
    names = {"ln1_scale": ("norm1.weight", False), "wqkv": ("attn.qkv.weight", True),
             "bqkv": ("attn.qkv.bias", False), "wo": ("attn.proj.weight", True),
             "bo": ("attn.proj.bias", False), "ln2_scale": ("norm2.weight", False)}
    if vcfg.intermediate_size:  # 2.5: RMS norms, gated SiLU MLP
        names.update({"w_gate": ("mlp.gate_proj.weight", True),
                      "b_gate": ("mlp.gate_proj.bias", False),
                      "w_up": ("mlp.up_proj.weight", True),
                      "b_up": ("mlp.up_proj.bias", False),
                      "w_down": ("mlp.down_proj.weight", True),
                      "b_down": ("mlp.down_proj.bias", False)})
    else:
        names.update({"ln1_bias": ("norm1.bias", False),
                      "ln2_bias": ("norm2.bias", False),
                      "w1": ("mlp.fc1.weight", True), "b1": ("mlp.fc1.bias", False),
                      "w2": ("mlp.fc2.weight", True), "b2": ("mlp.fc2.bias", False)})
    conv = r.get(prefix + "patch_embed.proj.weight")  # [e, C, tp, p, p]
    tree = {
        # voxel flatten order (C, tp, p, p), as frames_to_patches
        "patch_proj": conv.reshape(conv.shape[0], -1).T,
        "merge_ln_scale": r.get(prefix + "merger.ln_q.weight"),
        "merge_w1": r.get(prefix + "merger.mlp.0.weight").T,
        "merge_b1": r.get(prefix + "merger.mlp.0.bias"),
        "merge_w2": r.get(prefix + "merger.mlp.2.weight").T,
        "merge_b2": r.get(prefix + "merger.mlp.2.bias"),
        "layers": {k: _stack(r, vcfg.depth, B + hf, t) for k, (hf, t) in names.items()},
    }
    if not vcfg.rms_norm:
        tree["merge_ln_bias"] = r.get(prefix + "merger.ln_q.bias")
    return tree_into(qwen_vl_tower(vcfg, torch.float32, device), tree)


def load_qwen_vl_tower(path: str, device=None) -> Tuple:
    """The tower of a Qwen2-VL-layout checkpoint directory (either layout)
    and what its LLM needs → (tower, vision_cfg, llm_cfg, the LLM's tensor
    name prefix); the tower in f32.  A tp group's leader loads this alone
    and its ranks read their LLM shards (`parallel.CheckpointShards`)."""
    hf, llm_cfg = _hf_config(path)
    if not llm_cfg.mrope_section:
        raise ValueError("qwen2_vl config has no mrope_section")
    vcfg = Qwen2VLVisionConfig.from_hf_config(hf.get("vision_config") or {})
    if vcfg.out_hidden_size != llm_cfg.hidden_size:
        raise ValueError(f"tower output {vcfg.out_hidden_size} != LLM hidden "
                         f"{llm_cfg.hidden_size}")
    r = _ShardReader(path)
    if r.has("visual.patch_embed.proj.weight"):
        vis_prefix, llm_prefix = "visual.", ""
    elif r.has("model.visual.patch_embed.proj.weight"):
        vis_prefix, llm_prefix = "model.visual.", "model.language_"
    else:
        raise ValueError("no qwen2-vl visual tower found in checkpoint")
    tower = load_qwen_vl_vision_params(path, vcfg, reader=r, prefix=vis_prefix,
                                       device=device)
    return tower, vcfg, llm_cfg, llm_prefix


def load_qwen_vl(path: str, dtype=torch.bfloat16, device=None) -> Tuple:
    """A Qwen2-VL-layout checkpoint directory (either layout) → (llm,
    llm_cfg, tower, vision_cfg); the tower in f32."""
    tower, vcfg, llm_cfg, llm_prefix = load_qwen_vl_tower(path, device)
    llm = load_params(path, llm_cfg, dtype=dtype, prefix=llm_prefix,
                      device=device)
    return llm, llm_cfg, tower, vcfg

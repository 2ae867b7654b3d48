"""The LLaVA / CLIP vision tower of the port (the JAX package's
`models/vision.py`): a pre-LN ViT over fixed-size patches with a learned
class token, q/k/v/o biases, an optional pre-encoder LayerNorm, HF's
`vision_feature_layer` cut (-2: stop before the last layer, no post-norm)
and the exact-GELU 2-layer projector into the LLM's hidden size.

The towers are `nn.Module`s whose parameters keep the JAX names and
layout (``x @ w``, w [in, out]); per-layer parameters sit in
``tower.layers[i]``, so `tree_into` moves a JAX tree (layer stacks
[L, ...]) or a loader's numpy tree across unchanged.  Attention runs
through `ops.vision_attention.segment_attention`: one segment per image
(the hand-written kernel on the card, its plain version on the CPU).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..ops.vision_attention import segment_attention


@dataclass(frozen=True)
class VisionConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 256
    intermediate_size: int = 1024
    num_hidden_layers: int = 4
    num_attention_heads: int = 4
    out_hidden_size: int = 64  # LLM hidden size (projector output)
    layer_norm_eps: float = 1e-6
    # CLIP-checkpoint parity (llava towers): q/k/v/out biases, a learned
    # class token (position 0, dropped from the output: llava's "default"
    # feature select), a pre-encoder LayerNorm, a 2-layer GELU projector
    attention_bias: bool = False
    use_cls_token: bool = False
    pre_layernorm: bool = False
    projector_hidden: int = 0  # 0 → a single linear projector
    # HF `vision_feature_layer`: 0 runs every layer + post-LayerNorm; a
    # negative value indexes HF's hidden_states (-2, the llava default,
    # stops before the last layer and skips the post-LayerNorm)
    feature_layer: int = 0
    hidden_act: str = "quick_gelu"

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def tiny_vision_config(**over) -> VisionConfig:
    """Tiny tower for tests (pairs with models.tiny_config: out 64)."""
    base = dict(image_size=32, patch_size=8, hidden_size=32, intermediate_size=64,
                num_hidden_layers=2, num_attention_heads=2, out_hidden_size=64)
    base.update(over)
    return VisionConfig(**base)


class ParamBlock(nn.Module):
    """Named parameters of fixed shapes (``shapes``: name → shape); an
    absent optional parameter reads as None."""

    def __init__(self, shapes: Mapping[str, tuple], dtype, device):
        super().__init__()
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(
                torch.empty(shape, dtype=dtype, device=device),
                requires_grad=False))

    def get(self, name: str) -> Optional[torch.Tensor]:
        return self._parameters.get(name)


class Tower(nn.Module):
    """Top-level parameters in ``top`` and one `ParamBlock` per layer."""

    def __init__(self, cfg, top: Dict[str, tuple], layer: Dict[str, tuple],
                 depth: int, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        self.device = device = resolve_device(device)
        self.dtype = dtype
        self.top = ParamBlock(top, dtype, device)
        self.layers = nn.ModuleList(ParamBlock(layer, dtype, device)
                                    for _ in range(depth))

    def p(self, name: str) -> Optional[torch.Tensor]:
        return self.top.get(name)


def _from_numpy(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a, order="C"))


@torch.no_grad()
def tree_into(tower: Tower, tree: Mapping) -> Tower:
    """Copy a tree shaped like the JAX params (top-level arrays, and
    ``layers``: stacks [L, ...]) into `tower`; names must agree both ways."""
    layers = tree["layers"]
    want_top = set(tower.top._parameters)
    want_layer = set(tower.layers[0]._parameters)
    got_top = set(tree) - {"layers"}
    if got_top != want_top or set(layers) != want_layer:
        raise KeyError(
            f"tree differs from the tower: top {sorted(got_top ^ want_top)}, "
            f"layers {sorted(set(layers) ^ want_layer)}")
    for name in want_top:
        tower.top.get(name).copy_(_from_numpy(tree[name]))
    for name in want_layer:
        stacked = _from_numpy(layers[name])
        for i, lp in enumerate(tower.layers):
            lp.get(name).copy_(stacked[i])
    return tower


@torch.no_grad()
def init_random(tower: Tower, generator: torch.Generator,
                small=("pos_embed", "cls_token")) -> Tower:
    """The JAX init scales: matrices normal / sqrt(fan_in), norm scales 1,
    biases 0, positions and the class token normal x 0.02.  Drawn one
    tensor at a time in f32 on the generator's device."""
    blocks = [tower.top, *tower.layers]
    for blk in blocks:
        for name, t in blk._parameters.items():
            if name.endswith("_scale"):
                t.fill_(1.0)
            elif t.dim() == 1 and name not in small:  # biases
                t.zero_()
            else:
                scale = 0.02 if name in small else 1.0 / math.sqrt(t.shape[-2])
                w = torch.randn(t.shape, generator=generator, dtype=torch.float32,
                                device=generator.device)
                t.copy_((w * scale).to(t.dtype))
    return tower


def layer_norm(x: torch.Tensor, scale, bias, eps: float) -> torch.Tensor:
    """LayerNorm in f32, cast back (JAX `_layer_norm` / `_ln`)."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    out = (x32 - mu) * torch.rsqrt(var + eps) * scale.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    if name in ("gelu", "gelu_pytorch_tanh"):
        return torch.nn.functional.gelu(
            x, approximate="none" if name == "gelu" else "tanh")
    raise ValueError(f"unsupported vision hidden_act {name!r}")


def clip_tower(cfg: VisionConfig, dtype=torch.float32, device=None) -> Tower:
    """An empty LLaVA/CLIP tower of `cfg` (fill with `tree_into` or
    `init_random`)."""
    h, f = cfg.hidden_size, cfg.intermediate_size
    layer = {"ln1_scale": (h,), "ln1_bias": (h,), "wq": (h, h), "wk": (h, h),
             "wv": (h, h), "wo": (h, h), "ln2_scale": (h,), "ln2_bias": (h,),
             "w1": (h, f), "b1": (f,), "w2": (f, h), "b2": (h,)}
    if cfg.attention_bias:
        layer.update({"bq": (h,), "bk": (h,), "bv": (h,), "bo": (h,)})
    n_pos = cfg.num_patches + (1 if cfg.use_cls_token else 0)
    top = {"patch_proj": (cfg.patch_size * cfg.patch_size * 3, h),
           "pos_embed": (n_pos, h), "post_ln_scale": (h,), "post_ln_bias": (h,),
           "proj": (h, cfg.projector_hidden or cfg.out_hidden_size)}
    if cfg.use_cls_token:
        top["cls_token"] = (h,)
    if cfg.pre_layernorm:
        top.update({"pre_ln_scale": (h,), "pre_ln_bias": (h,)})
    if cfg.projector_hidden:
        top.update({"proj_b1": (cfg.projector_hidden,),
                    "proj2": (cfg.projector_hidden, cfg.out_hidden_size),
                    "proj_b2": (cfg.out_hidden_size,)})
    return Tower(cfg, top, layer, cfg.num_hidden_layers, dtype, device)


def init_vision_params(cfg: VisionConfig, generator: torch.Generator,
                       dtype=torch.float32, device=None) -> Tower:
    return init_random(clip_tower(cfg, dtype, device), generator)


def vision_params_from_jax(cfg, tree: Mapping, dtype=torch.float32,
                           device=None) -> Tower:
    """The port's tower from a JAX vision params tree converted to numpy
    (``jax.tree.map(np.asarray, params)``): `VisionConfig` → the CLIP
    tower, `qwen_vl.Qwen2VLVisionConfig` → the Qwen tower."""
    if isinstance(cfg, VisionConfig):
        tower = clip_tower(cfg, dtype, device)
    else:
        from .qwen_vl import qwen_vl_tower

        tower = qwen_vl_tower(cfg, dtype, device)
    return tree_into(tower, tree)


def _proj(x, w, b=None):
    y = x @ w
    return y if b is None else y + b


def _vit_layer(lp: ParamBlock, x: torch.Tensor, cfg: VisionConfig,
               cu_seqlens) -> torch.Tensor:
    N, S, h = x.shape
    nh, hd = cfg.num_attention_heads, cfg.head_dim
    a = layer_norm(x, lp.ln1_scale, lp.ln1_bias, cfg.layer_norm_eps)
    q, k, v = (_proj(a, lp.get(w), lp.get(b)).reshape(N * S, nh, hd).contiguous()
               for w, b in (("wq", "bq"), ("wk", "bk"), ("wv", "bv")))
    o = segment_attention(q, k, v, cu_seqlens).reshape(N, S, h)
    x = x + _proj(o.to(x.dtype), lp.wo, lp.get("bo"))
    m = layer_norm(x, lp.ln2_scale, lp.ln2_bias, cfg.layer_norm_eps)
    m = _proj(act(cfg.hidden_act, _proj(m, lp.w1, lp.b1)), lp.w2, lp.b2)
    return x + m.to(x.dtype)


@torch.no_grad()
def encode_images(tower: Tower, pixels: torch.Tensor) -> torch.Tensor:
    """[N, H, W, 3] float in [0, 1] → patch embeddings [N, num_patches,
    out_hidden] in the LLM's embedding space."""
    cfg = tower.cfg
    N = pixels.shape[0]
    p = cfg.patch_size
    g = cfg.image_size // p
    x = pixels.reshape(N, g, p, g, p, 3).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(N, g * g, p * p * 3).to(tower.dtype) @ tower.p("patch_proj")
    if cfg.use_cls_token:
        cls = tower.p("cls_token")[None, None].expand(N, 1, x.shape[-1])
        x = torch.cat([cls, x], dim=1)
    x = x + tower.p("pos_embed")[None]
    if cfg.pre_layernorm:
        x = layer_norm(x, tower.p("pre_ln_scale"), tower.p("pre_ln_bias"),
                       cfg.layer_norm_eps)
    S = x.shape[1]
    cu = [i * S for i in range(N + 1)]  # one segment per image
    n_run = (cfg.num_hidden_layers + 1 + cfg.feature_layer
             if cfg.feature_layer else cfg.num_hidden_layers)
    for lp in tower.layers[:n_run]:
        x = _vit_layer(lp, x, cfg, cu)
    if cfg.use_cls_token:
        x = x[:, 1:]  # llava "default" feature select: patches only
    if not cfg.feature_layer:
        x = layer_norm(x, tower.p("post_ln_scale"), tower.p("post_ln_bias"),
                       cfg.layer_norm_eps)
    out = x @ tower.p("proj")
    if cfg.projector_hidden:
        # llava projector_hidden_act "gelu" = torch nn.GELU = exact GELU
        out = torch.nn.functional.gelu(out + tower.p("proj_b1"))
        out = out @ tower.p("proj2") + tower.p("proj_b2")
    return out

"""The Qwen2-VL / Qwen2.5-VL vision tower of the port (the JAX package's
`models/qwen_vl.py`) and the host side of dynamic-resolution media:
`smart_resize`, `frames_to_patches`, `merged_tokens` and the M-RoPE
positions of a prompt (`mrope_positions`, `mrope_positions_from_runs`,
HF `get_rope_index`).

The tower: a Conv3d patch embedding as a matmul over flattened voxels,
2D rotary angles from each patch's (row, col) in merge-group-major order,
blocks of pre-norm attention + MLP (2.0: LayerNorm and a quick-GELU MLP;
2.5: RMSNorm and a gated SiLU MLP, with 112-px windows on every block but
`fullatt_block_indexes`), and the merger (norm, 2x2 concat, exact-GELU
MLP into the LLM's hidden size).

Attention runs through `ops.vision_attention.segment_attention` over
contiguous segments.  Full blocks attend within each temporal frame.
Windows are not contiguous in the merge-group-major stream, so the
2.5 tower permutes the stream into window order once before the blocks
(a stable sort by window id, which moves whole merge groups and keeps
every frame contiguous), runs the windowed blocks over one segment per
window and the full blocks over one per frame, and inverts the
permutation after the last block, as HF's `get_window_index` does.  That
is the JAX tower's same-window mask (`_window_ids`) with the masked
scores never computed.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.norm import rms_norm
from ..ops.vision_attention import segment_attention
from .vision import Tower, init_random, layer_norm, tree_into

# HF Qwen2VLImageProcessor normalization (OPENAI_CLIP_MEAN/STD)
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


@dataclass(frozen=True)
class Qwen2VLVisionConfig:
    embed_dim: int = 1280
    depth: int = 32
    num_heads: int = 16
    mlp_ratio: float = 4.0
    in_channels: int = 3
    patch_size: int = 14
    temporal_patch_size: int = 2
    spatial_merge_size: int = 2
    out_hidden_size: int = 1536  # LLM hidden (HF vision_config.hidden_size)
    # smart-resize pixel budget (HF min_pixels / max_pixels)
    min_pixels: int = 56 * 56
    max_pixels: int = 14 * 14 * 4 * 1280
    # the 2.5 tower: gated SiLU MLP width (None → 2.0's quick-GELU MLP),
    # windows of window_size px on every block but fullatt_block_indexes
    # (0 → every block frame-wide), RMSNorm everywhere, and video
    # temporal positions advancing tokens_per_second per frame (0 → 2.0's
    # arange(t))
    intermediate_size: Optional[int] = None
    window_size: int = 0
    fullatt_block_indexes: Tuple[int, ...] = ()
    rms_norm: bool = False
    tokens_per_second: float = 0.0

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def patch_dim(self) -> int:
        return (self.in_channels * self.temporal_patch_size
                * self.patch_size * self.patch_size)

    @property
    def merge_unit(self) -> int:
        return self.spatial_merge_size ** 2

    @staticmethod
    def from_hf_config(d: dict) -> "Qwen2VLVisionConfig":
        # 2.5 renames the dims: `hidden_size` is the TOWER width and
        # `out_hidden_size` the LLM's (2.0: embed_dim / hidden_size); its
        # presence (or window_size) marks the 2.5 tower
        if "out_hidden_size" in d or "window_size" in d:
            return Qwen2VLVisionConfig(
                embed_dim=d.get("hidden_size", 1280),
                depth=d.get("depth", 32),
                num_heads=d.get("num_heads", 16),
                in_channels=d.get("in_channels", d.get("in_chans", 3)),
                patch_size=d.get("patch_size", 14),
                temporal_patch_size=d.get("temporal_patch_size", 2),
                spatial_merge_size=d.get("spatial_merge_size", 2),
                out_hidden_size=d.get("out_hidden_size", 2048),
                min_pixels=d.get("min_pixels", 56 * 56),
                max_pixels=d.get("max_pixels", 14 * 14 * 4 * 1280),
                intermediate_size=d.get("intermediate_size", 3420),
                window_size=d.get("window_size", 112),
                fullatt_block_indexes=tuple(
                    d.get("fullatt_block_indexes", (7, 15, 23, 31))),
                rms_norm=True,
                tokens_per_second=d.get("tokens_per_second", 4.0),
            )
        return Qwen2VLVisionConfig(
            embed_dim=d.get("embed_dim", 1280),
            depth=d.get("depth", 32),
            num_heads=d.get("num_heads", 16),
            mlp_ratio=d.get("mlp_ratio", 4.0),
            in_channels=d.get("in_channels", d.get("in_chans", 3)),
            patch_size=d.get("patch_size", 14),
            temporal_patch_size=d.get("temporal_patch_size", 2),
            spatial_merge_size=d.get("spatial_merge_size", 2),
            out_hidden_size=d.get("hidden_size", 1536),
            min_pixels=d.get("min_pixels", 56 * 56),
            max_pixels=d.get("max_pixels", 14 * 14 * 4 * 1280),
        )


def tiny_qwen_vl_vision_config(**over) -> Qwen2VLVisionConfig:
    """Tiny tower for tests (pairs with models.tiny_config: out 64)."""
    base = dict(embed_dim=32, depth=2, num_heads=2, mlp_ratio=2.0,
                patch_size=4, temporal_patch_size=2, spatial_merge_size=2,
                out_hidden_size=64, min_pixels=8 * 8, max_pixels=64 * 64)
    base.update(over)
    return Qwen2VLVisionConfig(**base)


def qwen_vl_tower(cfg: Qwen2VLVisionConfig, dtype=torch.float32,
                  device=None) -> Tower:
    """An empty Qwen2-VL (or 2.5) tower of `cfg`."""
    e, mu = cfg.embed_dim, cfg.merge_unit
    layer = {"ln1_scale": (e,), "wqkv": (e, 3 * e), "bqkv": (3 * e,),
             "wo": (e, e), "bo": (e,), "ln2_scale": (e,)}
    if cfg.intermediate_size:
        f = cfg.intermediate_size
        layer.update({"w_gate": (e, f), "b_gate": (f,), "w_up": (e, f),
                      "b_up": (f,), "w_down": (f, e), "b_down": (e,)})
    else:
        f = int(cfg.embed_dim * cfg.mlp_ratio)
        layer.update({"ln1_bias": (e,), "ln2_bias": (e,), "w1": (e, f),
                      "b1": (f,), "w2": (f, e), "b2": (e,)})
    top = {"patch_proj": (cfg.patch_dim, e), "merge_ln_scale": (e,),
           "merge_w1": (mu * e, mu * e), "merge_b1": (mu * e,),
           "merge_w2": (mu * e, cfg.out_hidden_size),
           "merge_b2": (cfg.out_hidden_size,)}
    if not cfg.rms_norm:
        top["merge_ln_bias"] = (e,)
    return Tower(cfg, top, layer, cfg.depth, dtype, device)


def init_qwen_vl_vision_params(cfg: Qwen2VLVisionConfig,
                               generator: torch.Generator,
                               dtype=torch.float32, device=None) -> Tower:
    """Random weights with the JAX scales (normal / sqrt(fan_in), norms 1,
    biases 0)."""
    return init_random(qwen_vl_tower(cfg, dtype, device), generator)


def _merge_order(a: np.ndarray, h: int, w: int, m: int) -> np.ndarray:
    return a.reshape(h // m, m, w // m, m).transpose(0, 2, 1, 3).reshape(-1)


def _vision_rope(grid: Tuple[int, int, int], cfg: Qwen2VLVisionConfig) -> np.ndarray:
    """Per-patch rope angles [L, head_dim // 2] from (row, col), patches in
    merge-group-major order (HF `rot_pos_emb`)."""
    t, h, w = grid
    m = cfg.spatial_merge_size
    d4 = cfg.head_dim // 4
    inv = 1.0 / (10000.0 ** (np.arange(d4, dtype=np.float32) / d4))
    hp = _merge_order(np.arange(h)[:, None].repeat(w, 1), h, w, m)
    wp = _merge_order(np.arange(w)[None, :].repeat(h, 0), h, w, m)
    angles = np.concatenate([hp[:, None] * inv[None, :], wp[:, None] * inv[None, :]],
                            axis=1).astype(np.float32)
    return np.tile(angles, (t, 1))


def _window_ids(grid: Tuple[int, int, int], cfg: Qwen2VLVisionConfig) -> np.ndarray:
    """Per-patch window id of the 2.5 tower (stream order): windows tile
    the merged grid in window_size // merge // patch blocks per frame,
    cut at the borders (HF `get_window_index`)."""
    t, h, w = grid
    m = cfg.spatial_merge_size
    ws = max(cfg.window_size // m // cfg.patch_size, 1)
    mrow = _merge_order(np.arange(h)[:, None].repeat(w, 1), h, w, m) // m
    mcol = _merge_order(np.arange(w)[None, :].repeat(h, 0), h, w, m) // m
    nwc = -(-(w // m) // ws)
    nwr = -(-(h // m) // ws)
    wid = (mrow // ws) * nwc + (mcol // ws)
    return np.concatenate([wid + f * nwr * nwc for f in range(t)]).astype(np.int64)


def stream_layout(grid: Tuple[int, int, int], cfg: Qwen2VLVisionConfig):
    """(order or None, frame cu_seqlens, window cu_seqlens or None) of one
    medium: ``order`` permutes the stream into window order (its inverse
    restores it), the segments are offsets into the permuted stream."""
    t, h, w = grid
    cu_frames = [f * h * w for f in range(t + 1)]
    if not cfg.window_size:
        return None, cu_frames, None
    wid = _window_ids(grid, cfg)
    order = np.argsort(wid, kind="stable")
    counts = np.bincount(wid)
    cu_win = np.concatenate([[0], np.cumsum(counts[counts > 0])]).tolist()
    return order, cu_frames, cu_win


def _rot_half(x: torch.Tensor) -> torch.Tensor:
    d2 = x.shape[-1] // 2
    return torch.cat([-x[..., d2:], x[..., :d2]], dim=-1)


@torch.no_grad()
def encode_patches(tower: Tower, patches: torch.Tensor,
                   grid: Tuple[int, int, int]) -> torch.Tensor:
    """Flattened voxel patches of ONE image or video [L, patch_dim] →
    merged embeddings [L // merge_unit, out_hidden] in the LLM's embedding
    space."""
    cfg = tower.cfg
    L = patches.shape[0]
    e, nh, hd = cfg.embed_dim, cfg.num_heads, cfg.head_dim
    dev = tower.device
    x = patches.to(dev, tower.dtype) @ tower.p("patch_proj")
    angles = torch.from_numpy(_vision_rope(grid, cfg)).to(dev)
    order, cu_frames, cu_win = stream_layout(grid, cfg)
    if order is not None:
        perm = torch.from_numpy(order).to(dev)
        x, angles = x[perm], angles[perm]
    cos = torch.cos(torch.cat([angles, angles], -1))[:, None, :]  # [L, 1, hd]
    sin = torch.sin(torch.cat([angles, angles], -1))[:, None, :]
    full = set(cfg.fullatt_block_indexes) if cfg.window_size else None
    v25 = bool(cfg.intermediate_size)

    def norm(x, lp, pre):
        if cfg.rms_norm:
            return rms_norm(x, lp.get(pre + "_scale"), eps=1e-6)
        return layer_norm(x, lp.get(pre + "_scale"), lp.get(pre + "_bias"), 1e-6)

    for i, lp in enumerate(tower.layers):
        cu = cu_frames if full is None or i in full else cu_win
        a = norm(x, lp, "ln1")
        qkv = a @ lp.wqkv + lp.bqkv
        q, k, v = (t.reshape(L, nh, hd) for t in qkv.split(e, dim=-1))
        q = (q * cos + _rot_half(q) * sin).contiguous()
        k = (k * cos + _rot_half(k) * sin).contiguous()
        o = segment_attention(q, k, v.contiguous(), cu)
        x = x + (o.reshape(L, e).to(x.dtype) @ lp.wo + lp.bo)
        m_in = norm(x, lp, "ln2")
        if v25:  # gated SiLU MLP
            m = (torch.nn.functional.silu(m_in @ lp.w_gate + lp.b_gate)
                 * (m_in @ lp.w_up + lp.b_up))
            x = x + (m @ lp.w_down + lp.b_down).to(x.dtype)
        else:
            m = m_in @ lp.w1 + lp.b1
            m = m * torch.sigmoid(1.702 * m)  # quick_gelu
            x = x + (m @ lp.w2 + lp.b2).to(x.dtype)
    if order is not None:
        x = x[torch.from_numpy(np.argsort(order)).to(dev)]
    p = tower.p
    if cfg.rms_norm:
        x = rms_norm(x, p("merge_ln_scale"), eps=1e-6)
    else:
        x = layer_norm(x, p("merge_ln_scale"), p("merge_ln_bias"), 1e-6)
    x = x.reshape(L // cfg.merge_unit, cfg.merge_unit * e)
    x = torch.nn.functional.gelu(x @ p("merge_w1") + p("merge_b1"))
    return x @ p("merge_w2") + p("merge_b2")


# -- host-side preprocessing ------------------------------------------------- #


def smart_resize(height: int, width: int, cfg: Qwen2VLVisionConfig) -> Tuple[int, int]:
    """HF qwen-vl smart_resize: round to multiples of patch * merge while
    keeping the pixel count inside [min_pixels, max_pixels] and the aspect
    ratio (nearly) intact."""
    factor = cfg.patch_size * cfg.spatial_merge_size
    if max(height, width) / min(height, width) > 200:
        raise ValueError("absurd aspect ratio")
    h_bar = max(factor, round(height / factor) * factor)
    w_bar = max(factor, round(width / factor) * factor)
    if h_bar * w_bar > cfg.max_pixels:
        beta = math.sqrt((height * width) / cfg.max_pixels)
        h_bar = math.floor(height / beta / factor) * factor
        w_bar = math.floor(width / beta / factor) * factor
    elif h_bar * w_bar < cfg.min_pixels:
        beta = math.sqrt(cfg.min_pixels / (height * width))
        h_bar = math.ceil(height * beta / factor) * factor
        w_bar = math.ceil(width * beta / factor) * factor
    return max(factor, h_bar), max(factor, w_bar)


def frames_to_patches(frames: np.ndarray, cfg: Qwen2VLVisionConfig,
                      ) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """[T, H, W, 3] floats in [0, 1] (H, W smart-resized) → (patches
    [L, patch_dim] float32 in HF processor order, grid (t, h, w)).  An
    image (T 1) has its frame repeated across the temporal patch; a video's
    frame count rounds up to a temporal_patch_size multiple the same way."""
    T, H, W, C = frames.shape
    p, m, tp = cfg.patch_size, cfg.spatial_merge_size, cfg.temporal_patch_size
    if H % (p * m) or W % (p * m):
        raise ValueError(f"frame {H}x{W} not smart-resized (factor {p * m})")
    x = (frames.astype(np.float32) - CLIP_MEAN) / CLIP_STD
    if T % tp:
        pad = tp - T % tp
        x = np.concatenate([x, np.repeat(x[-1:], pad, 0)], 0)
        T += pad
    gt, gh, gw = T // tp, H // p, W // p
    x = x.reshape(gt, tp, gh // m, m, p, gw // m, m, p, C)
    x = x.transpose(0, 2, 5, 3, 6, 8, 1, 4, 7)
    patches = x.reshape(gt * gh * gw, C * tp * p * p)
    return np.ascontiguousarray(patches), (gt, gh, gw)


def merged_tokens(grid: Tuple[int, int, int], cfg: Qwen2VLVisionConfig) -> int:
    t, h, w = grid
    return t * h * w // cfg.merge_unit


def _temporal_index(t: int, cfg: Qwen2VLVisionConfig):
    """Per-frame temporal rope indices and the span they occupy (2.5:
    tokens_per_second per frame, second_per_grid taken as 1.0; 2.0: the
    frame count)."""
    if cfg.tokens_per_second:
        tt = (np.arange(t) * cfg.tokens_per_second * 1.0).astype(np.int32)
    else:
        tt = np.arange(t, dtype=np.int32)
    span = int(tt[-1]) + 1 if t else 1
    return tt, span


def _run_positions(pos: np.ndarray, i: int, nxt: int, grid,
                   cfg: Qwen2VLVisionConfig) -> Tuple[int, int]:
    """Fill one vision run's three streams at offset i; returns (end of the
    run, next scalar position)."""
    t, h, w = grid
    m = cfg.spatial_merge_size
    lh, lw = h // m, w // m
    n = t * lh * lw
    tt, t_span = _temporal_index(t, cfg)
    pos[0, i:i + n] = nxt + tt.repeat(lh * lw)
    pos[1, i:i + n] = nxt + np.tile(np.arange(lh, dtype=np.int32).repeat(lw), t)
    pos[2, i:i + n] = nxt + np.tile(np.tile(np.arange(lw, dtype=np.int32), lh), t)
    return i + n, nxt + max(t_span, lh, lw)


def mrope_positions(token_ids: Sequence[int], image_token_id: int,
                    grids: List[Tuple[int, int, int]],
                    cfg: Qwen2VLVisionConfig) -> Tuple[np.ndarray, int]:
    """(positions [3, S] int32, delta) for a prompt whose placeholder runs
    are expanded to `merged_tokens(grid)` copies each (HF
    `get_rope_index`).  delta = max position + 1 - len(tokens): every
    position after the prompt, decode steps included, ropes at its token
    index + delta."""
    S = len(token_ids)
    pos = np.zeros((3, S), np.int32)
    i = nxt = 0
    g = iter(grids)
    while i < S:
        if token_ids[i] == image_token_id:
            i, nxt = _run_positions(pos, i, nxt, next(g), cfg)
        else:
            pos[:, i] = nxt
            nxt += 1
            i += 1
    if next(g, None) is not None:
        raise ValueError("more grids than image runs in the prompt")
    return pos, int(nxt - S)


def mrope_positions_from_runs(total_len: int,
                              runs: List[Tuple[int, Tuple[int, int, int]]],
                              cfg: Qwen2VLVisionConfig) -> Tuple[np.ndarray, int]:
    """`mrope_positions` from each vision run's start offset and grid (the
    engine's view: the preprocessor expanded the placeholders already)."""
    pos = np.zeros((3, total_len), np.int32)
    i = nxt = 0
    for off, grid in sorted(runs):
        while i < off:
            pos[:, i] = nxt
            nxt += 1
            i += 1
        if off + merged_tokens(grid, cfg) > total_len:
            raise ValueError("vision run exceeds the prompt")
        i, nxt = _run_positions(pos, i, nxt, grid, cfg)
    while i < total_len:
        pos[:, i] = nxt
        nxt += 1
        i += 1
    return pos, int(nxt - total_len)


def vision_config(name_or_dict) -> Qwen2VLVisionConfig:
    """A canned model's tower (`config.VISION_CONFIGS`) or an HF
    `vision_config` dict."""
    if isinstance(name_or_dict, str):
        from .config import VISION_CONFIGS

        name_or_dict = VISION_CONFIGS[name_or_dict]
    return Qwen2VLVisionConfig.from_hf_config(dict(name_or_dict))


"""Rotary position embeddings (RoPE), including Llama-3 and YaRN frequency
scaling.  Applied in float32 then cast back (precision matters for long
context).  `apply_mrope` (Qwen2-VL) is not ported yet."""

from __future__ import annotations

import math
from typing import Optional

import torch


def _rope_type(scaling: Optional[dict]) -> Optional[str]:
    if not scaling:
        return None
    return scaling.get("rope_type", scaling.get("type"))


def rope_frequencies(
    head_dim: int,
    theta: float = 10000.0,
    scaling: Optional[dict] = None,
    device=None,
) -> torch.Tensor:
    """Inverse frequencies [head_dim//2] (f32), with optional llama3 or
    yarn scaling (HF `_compute_llama3_parameters` /
    `_compute_yarn_parameters`)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    inv_freq = 1.0 / (theta ** exps)
    kind = _rope_type(scaling)
    if kind == "yarn":
        factor = float(scaling["factor"])
        orig = float(scaling.get("original_max_position_embeddings", 4096))
        beta_fast = float(scaling.get("beta_fast", 32.0))
        beta_slow = float(scaling.get("beta_slow", 1.0))

        def dim_for(rotations: float) -> float:
            return (head_dim * math.log(orig / (rotations * 2 * math.pi))
                    ) / (2 * math.log(theta))

        low, high = dim_for(beta_fast), dim_for(beta_slow)
        if scaling.get("truncate", True):
            low, high = math.floor(low), math.ceil(high)
        low, high = max(low, 0.0), min(high, float(head_dim - 1))
        if low == high:
            high += 0.001  # HF linear_ramp_factor degenerate-band guard
        ramp = torch.clamp(
            (torch.arange(head_dim // 2, dtype=torch.float32, device=device) - low)
            / (high - low),
            0.0, 1.0,
        )
        keep = 1.0 - ramp  # 1 → keep the original frequency
        return (inv_freq / factor) * (1.0 - keep) + inv_freq * keep
    if kind == "llama3":
        factor = scaling["factor"]
        low = scaling["low_freq_factor"]
        high = scaling["high_freq_factor"]
        orig = scaling["original_max_position_embeddings"]
        wavelen = 2 * math.pi / inv_freq
        smooth = torch.clamp((orig / wavelen - low) / (high - low), 0.0, 1.0)
        inv_freq = (1 - smooth) * (inv_freq / factor) + smooth * inv_freq
    return inv_freq


def rope_attention_scale(scaling: Optional[dict]) -> float:
    """YaRN's amplitude factor (scales the roped q and k); 1.0 for every
    other rope flavour."""
    if _rope_type(scaling) != "yarn":
        return 1.0
    explicit = scaling.get("attention_factor")
    if explicit is not None:
        return float(explicit)
    factor = float(scaling["factor"])

    def get_mscale(scale: float, mscale: float = 1.0) -> float:
        if scale <= 1.0:
            return 1.0
        return 0.1 * mscale * math.log(scale) + 1.0

    mscale = scaling.get("mscale")
    mscale_all_dim = scaling.get("mscale_all_dim")
    if mscale and mscale_all_dim:
        return get_mscale(factor, float(mscale)) / get_mscale(
            factor, float(mscale_all_dim))
    return get_mscale(factor)


def rope_cos_sin(positions: torch.Tensor, inv_freq: torch.Tensor):
    """(cos, sin) [..., seq, 1, d/2] f32 for `positions` [..., seq]: computed
    once per step and shared by every layer's q and k."""
    angles = positions[..., None].float() * inv_freq
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
           scale: float = 1.0) -> torch.Tensor:
    """Rotate pairs (x[..., :d/2], x[..., d/2:]) by precomputed angles."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2].float(), x[..., d2:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    if scale != 1.0:
        out = out * scale
    return out.to(x.dtype)


def apply_rope(
    x: torch.Tensor,  # [..., seq, heads, head_dim]
    positions: torch.Tensor,  # [..., seq]
    inv_freq: torch.Tensor,  # [head_dim//2]
    scale: float = 1.0,  # yarn attention factor (rope_attention_scale)
) -> torch.Tensor:
    """Rotate pairs (x[..., :d/2], x[..., d/2:]) — HF llama convention."""
    return rotate(x, *rope_cos_sin(positions, inv_freq), scale)

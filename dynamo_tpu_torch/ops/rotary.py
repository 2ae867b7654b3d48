"""Rotary position embeddings (RoPE), including Llama-3 and YaRN frequency
scaling, and the multimodal M-RoPE of Qwen2-VL (`apply_mrope`).  Applied
in float32 then cast back (precision matters for long context)."""

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


def mrope_sections(section, device=None) -> torch.Tensor:
    """[d/2] int64: which position stream (0 temporal, 1 height, 2 width)
    each rotary frequency reads."""
    t, h, w = section
    return torch.cat([torch.full((n,), i, dtype=torch.int64, device=device)
                      for i, n in enumerate((t, h, w))])


def mrope_cos_sin(positions: torch.Tensor, inv_freq: torch.Tensor,
                  sec_of: torch.Tensor):
    """(cos, sin) [B, S, 1, d/2] f32 for the three streams `positions`
    [B, 3, S]: frequency i takes its angle from stream `sec_of[i]`."""
    pos = positions.float()[:, sec_of, :]  # [B, d/2, S]
    angles = pos.transpose(1, 2) * inv_freq  # [B, S, d/2]
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def apply_mrope(
    x: torch.Tensor,  # [B, seq, heads, head_dim]
    positions: torch.Tensor,  # [B, 3, seq] (temporal, height, width) ids
    inv_freq: torch.Tensor,  # [head_dim//2]
    section,  # 3 ints summing to head_dim//2 (HF mrope_section)
) -> torch.Tensor:
    """Multimodal rotary embedding (Qwen2-VL): the head_dim//2 rotary
    frequencies split into three contiguous sections that read their angle
    from the temporal / height / width position stream.  Text tokens carry
    equal ids on all three streams, for which this is exactly
    `apply_rope`; decode therefore needs only a scalar position shifted by
    the sequence's delta.  HF Qwen2VL `apply_multimodal_rotary_pos_emb`."""
    if sum(section) != inv_freq.shape[0]:
        raise ValueError(f"mrope section {section} != {inv_freq.shape[0]} frequencies")
    sec_of = mrope_sections(section, device=inv_freq.device)
    return rotate(x, *mrope_cos_sin(positions, inv_freq, sec_of))

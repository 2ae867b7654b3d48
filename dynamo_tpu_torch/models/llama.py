"""Dense Llama-family decoder in PyTorch over the paged KV pool — the port
of the dense part of the JAX package's `models/llama.py`.

- Weights keep the JAX layout (``x @ w`` with ``w`` [in, out]), so
  `params_from_jax` moves an `init_params` tree across unchanged.
- The KV pool is ``[L, P, page, n_kv, hd]`` for k and v, the JAX layout,
  updated in place.
- Decode is the per-step write-first form: the new token's KV is written
  into the pool, then attention reads it back through the page table.

MoE, sliding windows, attention sinks, qkv biases and M-RoPE are later
slices; a config that needs them is refused.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..ops import (
    decode_attention,
    prefill_attention,
    rms_norm,
    rope_attention_scale,
    rope_frequencies,
)
from ..ops.paged_attention import kv_slots, write_kv_slots
from ..ops.rotary import rope_cos_sin, rotate
from .config import ModelConfig


class KVCache:
    """Paged KV pool for all layers: k, v [L, P, page, n_kv, hd]."""

    def __init__(self, k: torch.Tensor, v: torch.Tensor):
        self.k = k
        self.v = v

    @property
    def page_size(self) -> int:
        return self.k.shape[2]

    @staticmethod
    def create(cfg: ModelConfig, num_pages: int, page_size: int,
               dtype=torch.bfloat16, device=None) -> "KVCache":
        device = resolve_device(device)
        shape = (cfg.num_hidden_layers, num_pages, page_size,
                 cfg.num_key_value_heads, cfg.head_dim_)
        return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                       torch.zeros(shape, dtype=dtype, device=device))


def _check_supported(cfg: ModelConfig) -> None:
    unsupported = {
        "MoE": cfg.is_moe,
        "M-RoPE": bool(cfg.mrope_section),
        "sliding windows": bool(cfg.sliding_window),
        "attention sinks": cfg.attention_sinks,
        "attention biases": cfg.attention_bias or cfg.attention_out_bias,
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(bad)} not ported yet (dense Llama only)")


class DecoderLayer(nn.Module):
    """One dense decoder layer: RMSNorm → q/k/v → rope → paged attention →
    o-proj → RMSNorm → SwiGLU MLP, with residuals."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        h, hd = cfg.hidden_size, cfg.head_dim_
        nh, nkv, f = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.intermediate_size
        self.cfg = cfg

        def p(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                                requires_grad=False)

        self.wq, self.wk, self.wv = p(h, nh * hd), p(h, nkv * hd), p(h, nkv * hd)
        self.wo = p(nh * hd, h)
        self.attn_norm, self.mlp_norm = p(h), p(h)
        self.w_gate, self.w_up, self.w_down = p(h, f), p(h, f), p(f, h)

    def _qkv(self, x: torch.Tensor):
        c = self.cfg
        q = (x @ self.wq).unflatten(-1, (c.num_attention_heads, c.head_dim_))
        k = (x @ self.wk).unflatten(-1, (c.num_key_value_heads, c.head_dim_))
        v = (x @ self.wv).unflatten(-1, (c.num_key_value_heads, c.head_dim_))
        return q, k, v

    def _mlp(self, x: torch.Tensor) -> torch.Tensor:
        act = torch.nn.functional.silu((x @ self.w_gate).float()) * (x @ self.w_up).float()
        return act.to(x.dtype) @ self.w_down

    def prefill(self, x, kv_layer, rope, page_table, prefix_lens, chunk_lens,
                slot):
        """x [B, S, h]; attends to the cached prefix + the chunk, then
        writes the chunk's KV into the pool at `slot`.  `rope` is the
        step's (cos, sin, scale), shared by every layer."""
        B, S, _ = x.shape
        k_pages, v_pages = kv_layer
        attn_in = rms_norm(x, self.attn_norm, self.cfg.rms_norm_eps)
        q, k, v = self._qkv(attn_in)
        q, k = rotate(q, *rope), rotate(k, *rope)
        v = v.contiguous()
        attn = prefill_attention(q, k, v, k_pages, v_pages, page_table,
                                 prefix_lens, chunk_lens)
        write_kv_slots(k_pages, v_pages, slot, k, v)
        x = x + attn.reshape(B, S, -1) @ self.wo
        return x + self._mlp(rms_norm(x, self.mlp_norm, self.cfg.rms_norm_eps))

    def decode(self, x, kv_layer, rope, page_table, seq_lens, slot):
        """x [B, h], one token per row: write its KV at `slot` first, then
        attend over the whole table (the new token included)."""
        B, _ = x.shape
        k_pages, v_pages = kv_layer
        attn_in = rms_norm(x, self.attn_norm, self.cfg.rms_norm_eps)
        q, k, v = self._qkv(attn_in[:, None])  # [B, 1, heads, hd]
        q, k = rotate(q, *rope)[:, 0], rotate(k, *rope)
        write_kv_slots(k_pages, v_pages, slot, k, v)
        attn = decode_attention(q, k_pages, v_pages, page_table, seq_lens)
        x = x + attn.reshape(B, -1) @ self.wo
        return x + self._mlp(rms_norm(x, self.mlp_norm, self.cfg.rms_norm_eps))


class Llama(nn.Module):
    """Embedding, decoder layers and LM head (tied or untied).  Like every
    entry point of the port it lives on the CUDA device unless the caller
    passes ``device="cpu"``; `KVCache.create`, `init_params` and
    `params_from_jax` resolve their device the same way."""

    def __init__(self, cfg: ModelConfig, dtype=torch.bfloat16, device=None):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        self.dtype = dtype
        self.device = device = resolve_device(device)
        h, V = cfg.hidden_size, cfg.vocab_size

        def p(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                                requires_grad=False)

        self.embed = p(V, h)
        self.final_norm = p(h)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, dtype, device) for _ in range(cfg.num_hidden_layers))
        self.lm_head = None if cfg.tie_word_embeddings else p(h, V)
        self.inv_freq = rope_frequencies(cfg.head_dim_, cfg.rope_theta,
                                         cfg.rope_scaling, device=device)
        self.rope_scale = rope_attention_scale(cfg.rope_scaling)

    def lm_logits(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm + LM head; f32 logits."""
        x = rms_norm(x, self.final_norm, self.cfg.rms_norm_eps)
        head = self.lm_head if self.lm_head is not None else self.embed.t()
        return (x @ head).float()

    def _prefill_layers(self, kv: KVCache, tokens, page_table, prefix_lens,
                        chunk_lens) -> torch.Tensor:
        """Embed a chunk (tokens [B, S]) and run every layer's prefill
        over it; returns the last hidden states [B, S, h]."""
        S = tokens.shape[1]
        positions = prefix_lens.long()[:, None] + torch.arange(
            S, device=tokens.device)[None, :]
        rope = (*rope_cos_sin(positions, self.inv_freq), self.rope_scale)
        slot = kv_slots(page_table, prefix_lens, chunk_lens, S, kv.page_size)
        x = self.embed[tokens]
        for i, layer in enumerate(self.layers):
            x = layer.prefill(x, (kv.k[i], kv.v[i]), rope, page_table,
                              prefix_lens, chunk_lens, slot)
        return x

    @torch.no_grad()
    def forward_prefill(self, kv: KVCache, tokens, page_table, prefix_lens,
                        chunk_lens) -> torch.Tensor:
        """Run a prefill chunk (tokens [B, S]); returns f32 logits at each
        row's last valid position [B, V]."""
        x = self._prefill_layers(kv, tokens, page_table, prefix_lens, chunk_lens)
        last = torch.clamp(chunk_lens.long() - 1, min=0)
        x_last = x[torch.arange(tokens.shape[0], device=x.device), last]
        return self.lm_logits(x_last)

    @torch.no_grad()
    def forward_verify(self, kv: KVCache, tokens, page_table, prefix_lens,
                       chunk_lens) -> torch.Tensor:
        """Score EVERY position of a short draft chunk (tokens [B, S]: the
        last accepted token, then S-1 drafts) in one forward: the verify
        step of self-speculative decoding.  `forward_prefill` with the
        logits of all S positions, f32 [B, S, V].  The whole chunk's KV is
        written; slots of rejected drafts are never attended (positions
        mask them) and are overwritten as decode advances."""
        x = self._prefill_layers(kv, tokens, page_table, prefix_lens, chunk_lens)
        return self.lm_logits(x)

    @torch.no_grad()
    def forward_decode(self, kv: KVCache, tokens, positions,
                       page_table) -> torch.Tensor:
        """One decode step for the batch (tokens, positions [B]); returns
        f32 logits [B, V]."""
        rope = (*rope_cos_sin(positions[:, None], self.inv_freq), self.rope_scale)
        slot = kv_slots(page_table, positions, torch.ones_like(positions), 1,
                        kv.page_size)
        seq_lens = (positions + 1).to(torch.int32)
        x = self.embed[tokens]
        for i, layer in enumerate(self.layers):
            x = layer.decode(x, (kv.k[i], kv.v[i]), rope, page_table,
                             seq_lens, slot)
        return self.lm_logits(x)


_LAYER_KEYS = ("wq", "wk", "wv", "wo", "attn_norm", "mlp_norm",
               "w_gate", "w_up", "w_down")


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype=torch.bfloat16, device=None) -> Llama:
    """Random weights from `generator` (drawn on the generator's device),
    with the JAX package's scales: normal / sqrt(fan_in), embedding 0.02,
    norms 1.  Drawn one tensor at a time in f32 and cast, so a full-size
    model never holds more than one f32 matrix at once."""
    model = Llama(cfg, dtype=dtype, device=device)

    def fill(t: torch.Tensor, scale: float) -> None:
        w = torch.randn(t.shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        t.copy_((w * scale).to(dtype))

    with torch.no_grad():
        for layer in model.layers:
            for name in _LAYER_KEYS:
                t = getattr(layer, name)
                if name.endswith("norm"):
                    t.fill_(1.0)
                else:
                    fill(t, 1.0 / math.sqrt(t.shape[0]))
        fill(model.embed, 0.02)
        model.final_norm.fill_(1.0)
        if model.lm_head is not None:
            fill(model.lm_head, 1.0 / math.sqrt(cfg.hidden_size))
    return model


def params_from_jax(cfg: ModelConfig, tree: Dict, dtype=None,
                    device=None) -> Llama:
    """The port's model from a JAX `init_params` tree already converted to
    numpy (``jax.tree.map(np.asarray, params)``): layer stacks
    [L, ...] become per-layer parameters.  `dtype` defaults to the
    tree's own (bf16 arrays arrive as ml_dtypes and go through f32)."""
    def t(a) -> torch.Tensor:
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(np.array(a))

    embed = t(tree["embed"])
    model = Llama(cfg, dtype=dtype or embed.dtype, device=device)
    with torch.no_grad():
        model.embed.copy_(embed)
        model.final_norm.copy_(t(tree["final_norm"]))
        if model.lm_head is not None:
            model.lm_head.copy_(t(tree["lm_head"]))
        for name in _LAYER_KEYS:
            stacked = t(tree["layers"][name])
            for i, layer in enumerate(model.layers):
                getattr(layer, name).copy_(stacked[i])
    return model

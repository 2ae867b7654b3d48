"""Llama-family decoder in PyTorch over the paged KV pool — the port of
the JAX package's `models/llama.py`.

- Weights keep the JAX layout (``x @ w`` with ``w`` [in, out]; expert
  stacks [E, in, out]), so `params_from_jax` moves an `init_params` tree
  across unchanged, int8 ``{"q", "s"}`` leaves included.
- The KV pool is ``[L, P, page, n_kv, hd]`` for k and v, the JAX layout,
  updated in place.
- Decode is the per-step write-first form: the new token's KV is written
  into the pool, then attention reads it back through the page table.
- Model features: q/k/v biases (qwen2), an o_proj bias and per-head
  attention sinks (gpt-oss), a sliding window per layer (mistral, gpt-oss;
  a Python int, so it is fixed inside captured decode graphs), and MoE
  (mixtral's silu experts, gpt-oss's biased router and clamped-GLU
  experts) dispatched by ``cfg.moe_impl``: ``ragged`` (the default; sort +
  the hand-written grouped GEMM, `ops/moe.py`), ``a2a`` (ragged outside a
  mesh), ``capacity`` (GShard one-hot dispatch) or ``dense`` (every expert
  on every token, the oracle).
- Multimodal prompts (Qwen2-VL, LLaVA): `forward_prefill` takes
  precomputed embeddings spliced in at masked positions
  (``extra_embeds``, ``extra_mask``) and, for M-RoPE models, the three
  rope streams of the chunk (``mm_positions``); decode and verify take a
  per-row ``rope_offset`` (the sequence's M-RoPE delta) that shifts rope
  only, never the KV slot.
- Embeddings (`forward_embed`): the prefill layer body at prefix 0 over
  whole inputs, mean-pooled and unit-normalised; no KV is kept.
- Tensor parallelism (``Llama(..., rank, tp)``, `parallel/`): a shard
  holds nh/tp q heads and nkv/tp kv heads with their slices of q/k/v,
  biases and sinks, ffn/tp of a dense MLP, E/tp experts (the router
  replicated), and vocab/tp rows of the embedding and LM head; its pool
  holds nkv/tp heads.  The row-parallel products (``wo``, ``w_down``, the
  experts' combine) are summed over the ranks in f32 and rounded once to
  the model's dtype, where the flat model rounds its one f32 sum: the two
  differ only in the order of f32 additions (the ranks' partial sums
  are added last), so a bf16 result moves by at most one rounding step
  and an f32 one by ~1e-7 relative.  ``bo`` is added once, after the sum.
  The embedding is vocab-parallel and the logits are gathered over the
  full vocabulary (both exact), so every rank samples the same token.
  At tp 1 none of this runs: the flat path is unchanged.
- Pipeline stages (``Llama(..., stage=s, pp=S)``, `parallel/pipeline.py`):
  a stage holds the decoder layers ``[s * L / S, (s + 1) * L / S)`` of
  the flat model, each tp-sharded as above, with their windows (JAX
  `_local_wins`); the embedding lives on stage 0, the final norm and the
  LM head on the last stage (and a tied head's embedding there too), and
  its pool holds L / S layers.  `stage_prefill`, `stage_decode` and
  `stage_embed` take hidden states in (stage 0 embeds token ids) and give
  hidden states out; the last stage's caller applies `lm_logits` or
  `embed_pool`.  The flat `forward_*` are a one-stage model's entry
  points followed by the head.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..parallel.collectives import all_reduce_sum, embed_lookup, gather_logits
from ..parallel.sharding import (
    TOP_AXES,
    check_divisible,
    param_shard_axes,
    shard,
    shard_params,
)
from ..ops import (
    decode_attention,
    prefill_attention,
    rms_norm,
    rope_attention_scale,
    rope_frequencies,
)
from ..ops import moe as _moe_ops
from ..ops.moe import grouped_gemm, grouped_glu
from ..ops.paged_attention import kv_slots, write_kv_slots
from ..ops.rotary import mrope_cos_sin, mrope_sections, rope_cos_sin, rotate
from .config import ModelConfig
from .quantization import _mm_f32, _swap, is_quantized, matmul_any


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
               dtype=torch.bfloat16, device=None, tp: int = 1,
               pp: int = 1) -> "KVCache":
        """A zeroed pool; at ``tp`` > 1 one rank's: nkv/tp kv heads; at
        ``pp`` > 1 one stage's: L/pp layers."""
        device = resolve_device(device)
        shape = (cfg.num_hidden_layers // pp, num_pages, page_size,
                 cfg.num_key_value_heads // tp, cfg.head_dim_)
        return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                       torch.zeros(shape, dtype=dtype, device=device))


def _check_supported(cfg: ModelConfig, tp: int = 1, pp: int = 1) -> None:
    if pp > 1 and cfg.num_hidden_layers % pp:
        raise ValueError(f"pp={pp} must divide num_hidden_layers="
                         f"{cfg.num_hidden_layers} ({cfg.name})")
    if cfg.mrope_section and sum(cfg.mrope_section) != cfg.head_dim_ // 2:
        raise ValueError(f"{cfg.name}: mrope_section {cfg.mrope_section} does "
                         f"not split the {cfg.head_dim_ // 2} rotary frequencies")
    if cfg.is_moe and cfg.moe_impl not in _MOE_IMPLS:
        raise ValueError(
            f"moe_impl must be ragged|a2a|capacity|dense, got {cfg.moe_impl!r}")
    check_divisible(cfg, tp)
    if tp > 1 and cfg.is_moe and cfg.moe_impl not in ("ragged", "a2a"):
        raise ValueError(f"moe_impl={cfg.moe_impl!r} under tp: experts shard "
                         f"over tp through the ragged dispatch (ragged|a2a)")


class TpComm:
    """A model's place in its tp group: its rank, the group's size, and
    the `parallel.TpGroup` its collectives run on (attached by the engine
    with `Llama.attach_group`; a shard without one cannot run forward)."""

    def __init__(self, rank: int = 0, tp: int = 1):
        self.rank = rank
        self.tp = tp
        self.group = None

    def pg(self):
        if self.group is None:
            raise RuntimeError("a tp shard runs its collectives on a tp group: "
                               "attach one (Llama.attach_group)")
        return self.group.dev_group

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        return all_reduce_sum(t, self.pg())


# 1-D parameters drawn at std 0.02 by `init_params` (the JAX scales)
_BIAS_KEYS = ("bq", "bk", "bv", "bo", "router_b", "b_gate", "b_up", "b_down")


def layer_keys(cfg: ModelConfig) -> Tuple[str, ...]:
    """The per-layer parameters of `cfg`: the keys of JAX `init_params`'
    ``layers`` tree."""
    keys = ["wq", "wk", "wv", "wo", "attn_norm", "mlp_norm"]
    if cfg.attention_bias:
        keys += ["bq", "bk", "bv"]
    if cfg.attention_out_bias:
        keys.append("bo")
    if cfg.attention_sinks:
        keys.append("sinks")
    if cfg.is_moe:
        keys.append("router")
    keys += ["w_gate", "w_up", "w_down"]
    if cfg.is_moe and cfg.moe_bias:
        keys += ["router_b", "b_gate", "b_up", "b_down"]
    return tuple(keys)


def _param_shapes(cfg: ModelConfig, tp: int = 1) -> Dict[str, tuple]:
    """Per-layer parameter shapes; at ``tp`` > 1 one rank's shard (the
    axis of `parallel.param_shard_axes` divided by tp)."""
    h, hd, f = cfg.hidden_size, cfg.head_dim_, cfg.intermediate_size
    nh, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
    shapes = {"wq": (h, nh * hd), "wk": (h, nkv * hd), "wv": (h, nkv * hd),
              "wo": (nh * hd, h), "attn_norm": (h,), "mlp_norm": (h,),
              "bq": (nh * hd,), "bk": (nkv * hd,), "bv": (nkv * hd,),
              "bo": (h,), "sinks": (nh,)}
    if cfg.is_moe:
        E, fm = cfg.num_experts, cfg.moe_intermediate_size or f
        shapes.update({"router": (h, E), "w_gate": (E, h, fm),
                       "w_up": (E, h, fm), "w_down": (E, fm, h),
                       "router_b": (E,), "b_gate": (E, fm), "b_up": (E, fm),
                       "b_down": (E, h)})
    else:
        shapes.update({"w_gate": (h, f), "w_up": (h, f), "w_down": (f, h)})
    if tp > 1:
        axes = param_shard_axes(cfg)
        for name, axis in axes.items():
            if axis is not None:
                shp = list(shapes[name])
                shp[axis] //= tp
                shapes[name] = tuple(shp)
    return shapes


# --------------------------------------------------------------------------- #
# MoE (JAX `moe_act`, `moe_router_logits`, `_moe_dense`, `_moe_ragged`,
# `_moe_capacity`, and `_moe` as `_MOE_IMPLS`); `lp` is a `DecoderLayer`
# --------------------------------------------------------------------------- #


def moe_act(cfg: ModelConfig, gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """Expert gating nonlinearity (float32 in/out): `ops.moe.moe_act` of
    ``cfg.moe_act``, the math the fused kernel's epilogue runs."""
    return _moe_ops.moe_act(cfg.moe_act, gate, up)


def moe_router_logits(lp, x: torch.Tensor) -> torch.Tensor:
    """Router logits in f32 ([..., E]): they pick experts discretely, so
    they are never rounded to bf16 (``preferred_element_type=f32``).  The
    product is the grouped GEMM with one group (f32 sums of exact
    products): on the card each row's sum then has one fixed order, so a
    token's routing does not change with how many rows share its
    dispatch, which a library GEMM picking its tiling by shape does not
    promise."""
    flat = x.reshape(-1, x.shape[-1])
    offs = torch.arange(2, dtype=torch.int32, device=x.device) * flat.shape[0]
    bias = lp.router_b[None] if lp.router_b is not None else None
    out = grouped_gemm(flat.contiguous(), lp.router[None], offs, bias)
    return out.reshape(*x.shape[:-1], out.shape[-1])


def _top_k(logits: torch.Tensor, k: int):
    """`jax.lax.top_k`: the k largest along the last axis, ties to the
    lower index (a stable descending sort; `torch.topk` promises no tie
    order on CUDA)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(lp, x: torch.Tensor, k: int):
    """(softmaxed top-k weights f32, expert ids int64), both [..., k]."""
    w, sel = _top_k(moe_router_logits(lp, x), k)
    return torch.softmax(w, dim=-1), sel


def _f32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.einsum(eq, a.float(), b.float())


def _moe_dense(lp, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Reference MoE: every expert computes every token, one-hot combine
    (the equality oracle)."""
    E, k, dt = cfg.num_experts, cfg.num_experts_per_tok, x.dtype
    weights, selected = _route(lp, x, k)  # [B, S, k]
    onehot = torch.nn.functional.one_hot(selected, E).to(dt)  # [B, S, k, E]
    combine = _f32("bsk,bske->bse", weights.to(dt), onehot).to(dt)
    gate = _f32("bsh,ehf->ebsf", x, lp.w_gate)
    up = _f32("bsh,ehf->ebsf", x, lp.w_up)
    if lp.b_gate is not None:
        gate = gate + lp.b_gate.float()[:, None, None, :]
        up = up + lp.b_up.float()[:, None, None, :]
    act = moe_act(cfg, gate, up).to(dt)
    out = _f32("ebsf,efh->ebsh", act, lp.w_down)
    if lp.b_down is not None:
        out = out + lp.b_down.float()[:, None, None, :]
    return _f32("ebsh,bse->bsh", out.to(dt), combine).to(dt)


def _moe_ragged(lp, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Dropless top-k MoE: assignments sorted by expert, each expert's
    rows through the grouped kernels (`ops/moe.py`), so compute is exactly
    T*k FFN rows and no token is dropped: gate and up in one launch with
    their biases and `moe_act` (bf16 out), then the down product with its
    bias (f32 out), JAX's order of sums, bias, activation and rounding.

    Nothing here syncs the host or sizes a tensor from the data (it runs
    inside the decode CUDA graphs): a stable argsort, group counts by
    `scatter_add_` into E zeros, prefix offsets by a device cumsum.  A
    token's result does not depend on its batch-mates: the grouped GEMM
    sums each row over K in one fixed order, and the combine scatters the
    sorted rows back to [T, k, h] by the inverse permutation (unique
    indices, no atomics) and adds the k rows in order.

    Under tp (JAX's ``ep_axis="tp"``) a rank holds E/tp experts and the
    router whole: its own experts' assignments sort first, by expert, and
    the other ranks' ride its last group (the kernels' groups must cover
    every row, and A stays T*k), where the combine weighs them 0; the
    f32 sums of the ranks are then added by an all-reduce."""
    B, S, h = x.shape
    k, dt = cfg.num_experts_per_tok, x.dtype
    E = lp.w_gate.shape[0]  # this rank's experts
    T = B * S
    A = T * k
    xf = x.reshape(T, h)
    weights, selected = _route(lp, xf, k)  # [T, k]
    expert_of = selected.reshape(A)  # assignment -> expert
    mine = None
    if lp.comm.tp > 1:
        local = expert_of - lp.comm.rank * E
        mine = (local >= 0) & (local < E)
        expert_of = torch.where(mine, local, torch.full_like(local, E - 1))
    order = torch.argsort(expert_of, stable=True)  # group by expert
    token_of = order // k  # assignment a (row-major [T, k]) is token a // k
    xs = xf[token_of]  # [A, h] rows sorted by expert
    counts = torch.zeros(E, dtype=torch.int32, device=x.device).scatter_add_(
        0, expert_of, torch.ones(A, dtype=torch.int32, device=x.device))
    offs = torch.cat([torch.zeros(1, dtype=torch.int32, device=x.device),
                      counts.cumsum(0, dtype=torch.int32)])

    act = grouped_glu(xs, lp.w_gate, lp.w_up, lp.b_gate, lp.b_up, offs,
                      cfg.moe_act)  # [A, f] in dt
    ys = grouped_gemm(act, lp.w_down, offs, lp.b_down)  # f32 [A, h]

    contrib = ys * weights.reshape(A)[order][:, None]
    if mine is not None:  # another rank's row: 0, whatever its product
        contrib = torch.where(mine[order][:, None], contrib,
                              torch.zeros_like(contrib))
    slots = torch.empty_like(contrib).index_copy_(0, order, contrib)
    slots = slots.view(T, k, h)
    out = slots[:, 0]
    for j in range(1, k):
        out = out + slots[:, j]
    if mine is not None:
        out = lp.comm.all_reduce(out.contiguous())
    return out.reshape(B, S, h).to(dt)


def _moe_capacity(lp, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Top-k MoE via capacity-bounded expert dispatch (the GShard/Switch
    pattern): tokens scatter into per-expert buffers [E, C, h] within
    groups of ``moe_group_size`` tokens; assignments past an expert's
    capacity are dropped (their residual passes through)."""
    B, S, h = x.shape
    E, k, dt = cfg.num_experts, cfg.num_experts_per_tok, x.dtype
    T = B * S
    cap_f = cfg.moe_capacity_factor
    if cap_f <= 0:  # dense fallback (tests / tiny models)
        return _moe_dense(lp, x, cfg)
    G = min(T, cfg.moe_group_size)
    Tp = -(-T // G) * G
    n_g = Tp // G
    C = max(1, int(-(-G * k * cap_f // E)))

    xf = x.reshape(T, h)
    if Tp != T:
        xf = torch.nn.functional.pad(xf, (0, 0, 0, Tp - T))
    xg = xf.reshape(n_g, G, h)
    weights, selected = _route(lp, xg, k)  # [n_g, G, k]

    F = torch.nn.functional
    ohf = F.one_hot(selected, E).to(torch.int32).reshape(n_g, G * k, E)
    pos = torch.cumsum(ohf, dim=1, dtype=torch.int32) - ohf  # prior per expert
    pos = (pos * ohf).sum(-1)  # [n_g, G*k]
    keep = (pos < C).to(dt)
    disp = (ohf.to(dt)[..., None]
            * F.one_hot(torch.clamp(pos, 0, C - 1).long(), C).to(dt)[..., None, :]
            * keep[..., None, None])  # [n_g, G*k, E, C]
    xrep = torch.repeat_interleave(xg, k, dim=1)  # [n_g, G*k, h]
    xe = _f32("gaec,gah->gech", disp, xrep).to(dt)  # [n_g, E, C, h]

    gate = _f32("gech,ehf->gecf", xe, lp.w_gate)
    up = _f32("gech,ehf->gecf", xe, lp.w_up)
    if lp.b_gate is not None:
        gate = gate + lp.b_gate.float()[None, :, None, :]
        up = up + lp.b_up.float()[None, :, None, :]
    act = moe_act(cfg, gate, up).to(dt)
    ye = _f32("gecf,efh->gech", act, lp.w_down)
    if lp.b_down is not None:
        ye = ye + lp.b_down.float()[None, :, None, :]

    wf = weights.to(dt).reshape(n_g, G * k)
    out = _f32("gaec,gech->gah", disp * wf[..., None, None], ye.to(dt))
    out = out.reshape(n_g, G, k, h).sum(dim=2).reshape(Tp, h)[:T]
    return out.reshape(B, S, h).to(dt)


# cfg.moe_impl -> dispatch; "a2a" (wide-EP all-to-all) exists only inside
# an expert-sharded mesh, and on one device is the ragged dispatch's math
_MOE_IMPLS = {"ragged": _moe_ragged, "a2a": _moe_ragged,
              "capacity": _moe_capacity, "dense": _moe_dense}


# --------------------------------------------------------------------------- #
# layers
# --------------------------------------------------------------------------- #


class DecoderLayer(nn.Module):
    """One decoder layer: RMSNorm → q/k/v (+ biases) → rope → paged
    attention (window, sinks) → o-proj (+ bias) → RMSNorm → SwiGLU MLP or
    MoE, with residuals.  `window` is this layer's sliding window (0 =
    full attention)."""

    def __init__(self, cfg: ModelConfig, dtype, device, window: int = 0,
                 comm: TpComm = None):
        super().__init__()
        self.cfg = cfg
        self.window = int(window)
        self.comm = comm or TpComm()
        keys = set(layer_keys(cfg))
        # every optional parameter the config lacks is None
        for name, shape in _param_shapes(cfg, self.comm.tp).items():
            setattr(self, name, nn.Parameter(
                torch.empty(shape, dtype=dtype, device=device),
                requires_grad=False) if name in keys else None)

    def _proj(self, x, w, b=None):
        """x @ w (+ b) in x's dtype; an int8 weight's f32 product takes the
        bias before its one rounding, as in JAX."""
        if is_quantized(w):
            y = matmul_any(x, w)
            if b is not None:
                y = y + b.float()
            return y.to(x.dtype)
        y = x @ w
        return y if b is None else y + b

    def _row_out(self, x, w):
        """x @ w of a row-parallel weight: without tp `_proj`; under tp
        this rank's f32 partial product, summed over the ranks, rounded
        once to x's dtype."""
        if self.comm.tp == 1:
            return self._proj(x, w)
        y = matmul_any(x, w) if is_quantized(w) else _mm_f32(x, w)
        return self.comm.all_reduce(y.contiguous()).to(x.dtype)

    def _qkv(self, x: torch.Tensor):
        c, tp = self.cfg, self.comm.tp
        q = self._proj(x, self.wq, self.bq).unflatten(
            -1, (c.num_attention_heads // tp, c.head_dim_))
        k = self._proj(x, self.wk, self.bk).unflatten(
            -1, (c.num_key_value_heads // tp, c.head_dim_))
        v = self._proj(x, self.wv, self.bv).unflatten(
            -1, (c.num_key_value_heads // tp, c.head_dim_))
        return q, k, v

    def _attn_out(self, attn: torch.Tensor) -> torch.Tensor:
        y = self._row_out(attn, self.wo)
        return y if self.bo is None else y + self.bo

    def _mlp(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, S, h]: SwiGLU, or the MoE of ``cfg.moe_impl``."""
        if self.cfg.is_moe:
            return _MOE_IMPLS[self.cfg.moe_impl](self, x, self.cfg)
        act = (torch.nn.functional.silu(matmul_any(x, self.w_gate))
               * matmul_any(x, self.w_up))
        return self._row_out(act.to(x.dtype), self.w_down)

    def _attn_extras(self):
        """(window or None, f32 sinks or None) for the kernels."""
        sink = None if self.sinks is None else self.sinks.float()
        return self.window or None, sink

    def prefill(self, x, kv_layer, rope, page_table, prefix_lens, chunk_lens,
                slot):
        """x [B, S, h]; attends to the cached prefix + the chunk, then
        writes the chunk's KV into the pool at `slot` (None: no write, the
        cache-free embed).  `rope` is the step's (cos, sin, scale), shared
        by every layer."""
        B, S, _ = x.shape
        k_pages, v_pages = kv_layer
        attn_in = rms_norm(x, self.attn_norm, self.cfg.rms_norm_eps)
        q, k, v = self._qkv(attn_in)
        q, k = rotate(q, *rope), rotate(k, *rope)
        v = v.contiguous()
        window, sink = self._attn_extras()
        attn = prefill_attention(q, k, v, k_pages, v_pages, page_table,
                                 prefix_lens, chunk_lens, window=window,
                                 sink=sink)
        if slot is not None:
            write_kv_slots(k_pages, v_pages, slot, k, v)
        x = x + self._attn_out(attn.reshape(B, S, -1))
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
        window, sink = self._attn_extras()
        attn = decode_attention(q, k_pages, v_pages, page_table, seq_lens,
                                window=window, sink=sink)
        x = x + self._attn_out(attn.reshape(B, -1))
        mlp_in = rms_norm(x, self.mlp_norm, self.cfg.rms_norm_eps)
        return x + self._mlp(mlp_in[:, None])[:, 0]


class Llama(nn.Module):
    """Embedding, decoder layers and LM head (tied or untied).  Like every
    entry point of the port it lives on the CUDA device unless the caller
    passes ``device="cpu"``; `KVCache.create`, `init_params` and
    `params_from_jax` resolve their device the same way.  The MoE path
    runs the grouped GEMM kernel on the card, which takes bf16 only.
    ``stage`` / ``pp``: a pipeline stage's model (the module docstring)."""

    def __init__(self, cfg: ModelConfig, dtype=torch.bfloat16, device=None,
                 rank: int = 0, tp: int = 1, stage: int = 0, pp: int = 1):
        super().__init__()
        _check_supported(cfg, tp, pp)
        self.cfg = cfg
        self.dtype = dtype
        self.device = device = resolve_device(device)
        self.comm = TpComm(rank, tp)
        self.stage, self.pp = stage, pp
        n = cfg.num_hidden_layers // pp
        # the global indices of this stage's layers
        self.layer_range = range(stage * n, (stage + 1) * n)
        h, V = cfg.hidden_size, cfg.vocab_size // tp

        def p(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                                requires_grad=False)

        self.embed = (p(V, h) if self.first_stage or (
            self.last_stage and cfg.tie_word_embeddings) else None)
        self.final_norm = p(h) if self.last_stage else None
        windows = cfg.layer_windows()
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, dtype, device, windows[i], self.comm)
            for i in self.layer_range)
        self.lm_head = (p(h, V) if self.last_stage
                        and not cfg.tie_word_embeddings else None)
        self.inv_freq = rope_frequencies(cfg.head_dim_, cfg.rope_theta,
                                         cfg.rope_scaling, device=device)
        self.rope_scale = rope_attention_scale(cfg.rope_scaling)
        self.mrope_sec = (mrope_sections(cfg.mrope_section, device=device)
                          if cfg.mrope_section else None)

    @property
    def tp(self) -> int:
        return self.comm.tp

    @property
    def first_stage(self) -> bool:
        return self.stage == 0

    @property
    def last_stage(self) -> bool:
        return self.stage == self.pp - 1

    def attach_group(self, group) -> None:
        """Run this shard's collectives on `group` (a `parallel.TpGroup`:
        its (replica, stage)'s tp group of ``tp`` ranks, this model's rank
        among them; the replicas of a group hold the same shards)."""
        if (group.tp, group.tp_rank) != (self.comm.tp, self.comm.rank):
            raise ValueError(f"a shard of rank {self.comm.rank} of "
                             f"{self.comm.tp} on tensor rank {group.tp_rank} "
                             f"of {group.tp}")
        if (group.pp, group.stage) != (self.pp, self.stage):
            raise ValueError(f"a model of stage {self.stage} of {self.pp} on "
                             f"stage {group.stage} of {group.pp}")
        self.comm.group = group

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        if self.comm.tp == 1:
            return self.embed[tokens]
        return embed_lookup(self.embed, tokens, self.comm.rank, self.comm.pg())

    def lm_logits(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm + LM head; f32 logits.  An int8 head (quantization
        adds one even when tied) goes through `matmul_any`.  Under tp each
        rank's vocabulary slice is gathered to the full width."""
        x = rms_norm(x, self.final_norm, self.cfg.rms_norm_eps)
        head = self.lm_head if self.lm_head is not None else self.embed.t()
        logits = matmul_any(x, head)
        if self.comm.tp == 1:
            return logits
        return gather_logits(logits, self.comm.rank, self.comm.tp,
                             self.comm.pg())

    def _prefill_layers(self, kv: KVCache, tokens, page_table, prefix_lens,
                        chunk_lens, extra_embeds=None, extra_mask=None,
                        mm_positions=None, rope_offset=None,
                        x=None) -> torch.Tensor:
        """Embed a chunk (tokens [B, S]; rows of ``extra_embeds`` [B, S, h]
        replace the embedding where ``extra_mask`` [B, S] is set), or take
        the previous stage's hidden states `x` [B, S, h], and run every
        layer's prefill over it; returns the last hidden states [B, S, h].
        An M-RoPE model ropes by ``mm_positions`` [B, 3, S] when given,
        else text-style; ``rope_offset`` [B] shifts the rope positions
        (verify), never the KV slots."""
        S = tokens.shape[1]
        positions = prefix_lens.long()[:, None] + torch.arange(
            S, device=tokens.device)[None, :]
        if rope_offset is not None:
            positions = positions + rope_offset.long()[:, None]
        if mm_positions is not None and self.mrope_sec is not None:
            rope = (*mrope_cos_sin(mm_positions, self.inv_freq, self.mrope_sec),
                    1.0)
        else:
            rope = (*rope_cos_sin(positions, self.inv_freq), self.rope_scale)
        slot = kv_slots(page_table, prefix_lens, chunk_lens, S, kv.page_size)
        if x is None:
            x = self._embed(tokens)
            if extra_embeds is not None:
                x = torch.where(extra_mask[..., None], extra_embeds.to(x.dtype), x)
        for i, layer in enumerate(self.layers):
            x = layer.prefill(x, (kv.k[i], kv.v[i]), rope, page_table,
                              prefix_lens, chunk_lens, slot)
        return x

    @torch.no_grad()
    def stage_prefill(self, kv: KVCache, tokens, page_table, prefix_lens,
                      chunk_lens, x=None) -> torch.Tensor:
        """This stage's layers over a prefill chunk: stage 0 embeds
        `tokens` [B, S], a later stage takes the previous stage's hidden
        states `x` [B, S, h] (`tokens` then gives only the chunk's
        width); returns the hidden states [B, S, h] after its layers."""
        return self._prefill_layers(kv, tokens, page_table, prefix_lens,
                                    chunk_lens, x=x)

    @torch.no_grad()
    def forward_prefill(self, kv: KVCache, tokens, page_table, prefix_lens,
                        chunk_lens, extra_embeds=None, extra_mask=None,
                        mm_positions=None) -> torch.Tensor:
        """Run a prefill chunk (tokens [B, S]); returns f32 logits at each
        row's last valid position [B, V].  ``extra_embeds`` / ``extra_mask``
        splice in vision embeddings; ``mm_positions`` [B, 3, S] are an
        M-RoPE model's rope streams (without them it ropes text-style,
        exact for text-only prompts)."""
        x = self._prefill_layers(kv, tokens, page_table, prefix_lens, chunk_lens,
                                 extra_embeds, extra_mask, mm_positions)
        return self.lm_logits(last_positions(x, chunk_lens))

    @torch.no_grad()
    def forward_verify(self, kv: KVCache, tokens, page_table, prefix_lens,
                       chunk_lens, rope_offset=None) -> torch.Tensor:
        """Score EVERY position of a short draft chunk (tokens [B, S]: the
        last accepted token, then S-1 drafts) in one forward: the verify
        step of self-speculative decoding.  `forward_prefill` with the
        logits of all S positions, f32 [B, S, V]; it rides the prefill
        layer body, so every model feature is the prefill's.  The whole
        chunk's KV is written; slots of rejected drafts are never attended
        (positions mask them) and are overwritten as decode advances.
        ``rope_offset`` [B] is each row's M-RoPE delta (rope only)."""
        x = self._prefill_layers(kv, tokens, page_table, prefix_lens, chunk_lens,
                                 rope_offset=rope_offset)
        return self.lm_logits(x)

    @torch.no_grad()
    def stage_embed(self, tokens: torch.Tensor, lens: torch.Tensor,
                    x=None) -> torch.Tensor:
        """This stage's layers of `forward_embed` (stage 0 embeds `tokens`
        [B, S], a later stage takes the previous stage's hidden states
        `x`): every layer's prefill body at prefix 0 with chunk_lens =
        lens.  Cache-free: with no prefix the attention reads no page, so
        a one-slot page in the model's dtype and a zero table stand in for
        the pool, and no KV is written.  Returns the hidden states [B, S,
        h]."""
        B, S = tokens.shape
        dev = tokens.device
        c = self.cfg
        positions = torch.arange(S, device=dev)[None, :].expand(B, S)
        rope = (*rope_cos_sin(positions, self.inv_freq), self.rope_scale)
        lens = lens.to(device=dev, dtype=torch.int32)
        prefix = torch.zeros(B, dtype=torch.int32, device=dev)
        table = torch.zeros((B, 1), dtype=torch.int32, device=dev)
        page = torch.zeros((1, 1, c.num_key_value_heads // self.tp, c.head_dim_),
                           dtype=self.dtype, device=dev)
        if x is None:
            x = self._embed(tokens)
        for layer in self.layers:
            x = layer.prefill(x, (page, page), rope, table, prefix, lens, None)
        return x

    @torch.no_grad()
    def embed_pool(self, x: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
        """The last stage's tail of `forward_embed`: the final norm, the
        f32 mean over valid positions (divisor floored at 1),
        unit-normalised (norm floored at 1e-9); f32 [B, h]."""
        S = x.shape[1]
        lens = lens.to(device=x.device, dtype=torch.int32)
        x = rms_norm(x, self.final_norm, self.cfg.rms_norm_eps)
        mask = (torch.arange(S, device=x.device)[None, :]
                < lens[:, None]).float()
        pooled = (x.float() * mask[..., None]).sum(1)
        pooled = pooled / lens.float().clamp_min(1.0)[:, None]
        return pooled / torch.linalg.vector_norm(
            pooled, dim=-1, keepdim=True).clamp_min(1e-9)

    @torch.no_grad()
    def forward_embed(self, tokens: torch.Tensor,
                      lens: torch.Tensor) -> torch.Tensor:
        """Sequence embeddings (tokens [B, S], valid lengths ``lens`` [B]):
        every layer's prefill body at prefix 0 with chunk_lens = lens
        (`stage_embed`), then `embed_pool`; f32 [B, h].  Positions are
        0..S-1 with 1-D rope, an M-RoPE model's too.  No KV is written."""
        return self.embed_pool(self.stage_embed(tokens, lens), lens)

    @torch.no_grad()
    def stage_decode(self, kv: KVCache, tokens, positions, page_table,
                     rope_offset=None, x=None) -> torch.Tensor:
        """This stage's layers over one decode step (positions [B]):
        stage 0 embeds `tokens` [B], a later stage takes the previous
        stage's hidden states `x` [B, h]; returns [B, h] after its
        layers."""
        rp = positions if rope_offset is None else positions + rope_offset
        rope = (*rope_cos_sin(rp[:, None], self.inv_freq), self.rope_scale)
        slot = kv_slots(page_table, positions, torch.ones_like(positions), 1,
                        kv.page_size)
        seq_lens = (positions + 1).to(torch.int32)
        if x is None:
            x = self._embed(tokens)
        for i, layer in enumerate(self.layers):
            x = layer.decode(x, (kv.k[i], kv.v[i]), rope, page_table,
                             seq_lens, slot)
        return x

    @torch.no_grad()
    def forward_decode(self, kv: KVCache, tokens, positions, page_table,
                       rope_offset=None) -> torch.Tensor:
        """One decode step for the batch (tokens, positions [B]); returns
        f32 logits [B, V].  ``rope_offset`` [B] (an M-RoPE model's
        per-row delta) shifts the rope position; the KV slot stays the
        token's index."""
        return self.lm_logits(self.stage_decode(kv, tokens, positions,
                                                page_table, rope_offset))


def last_positions(x: torch.Tensor, chunk_lens: torch.Tensor) -> torch.Tensor:
    """Each row's hidden state at its last valid position: x [B, S, h] ->
    [B, h]."""
    last = torch.clamp(chunk_lens.long() - 1, min=0)
    return x[torch.arange(x.shape[0], device=x.device), last]


def _init_scale(name: str, t: torch.Tensor) -> float:
    """The JAX package's `init_params` scales."""
    if name in _BIAS_KEYS:
        return 0.02
    if name == "sinks":
        return 1.0
    return 1.0 / math.sqrt(t.shape[-2])


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype=torch.bfloat16, device=None, rank: int = 0,
                tp: int = 1, stage: int = 0, pp: int = 1) -> Llama:
    """Random weights from `generator` (drawn on the generator's device),
    with the JAX package's scales: normal / sqrt(fan_in) (expert stacks
    too), biases 0.02, sinks 1, embedding 0.02, norms 1.  Drawn one tensor
    at a time in f32 and cast, so a full-size model never holds more than
    one f32 tensor at once.  With ``tp`` > 1 the model is rank `rank`'s
    shard: every tensor is still drawn whole, in the flat model's order,
    and the rank keeps its slice, so the shards of one seed are the flat
    model's values.  With ``pp`` > 1 the model is stage `stage`'s: every
    layer is drawn, and the stage keeps its own."""
    model = Llama(cfg, dtype=dtype, device=device, rank=rank, tp=tp,
                  stage=stage, pp=pp)
    full = _param_shapes(cfg)
    axes = param_shard_axes(cfg)

    def fill(t: torch.Tensor, shape, scale: float, axis=None) -> None:
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        if t is None:  # another stage's: drawn to keep the stream's order
            return
        t.copy_((shard(w, axis, rank, tp) * scale).to(dtype))

    with torch.no_grad():
        for i in range(cfg.num_hidden_layers):
            layer = (model.layers[i - model.layer_range.start]
                     if i in model.layer_range else None)
            for name in layer_keys(cfg):
                t = None if layer is None else getattr(layer, name)
                if name.endswith("norm"):
                    if t is not None:
                        t.fill_(1.0)
                else:
                    w = torch.empty(full[name], device="meta")
                    fill(t, full[name], _init_scale(name, w), axes[name])
        h, V = cfg.hidden_size, cfg.vocab_size
        fill(model.embed, (V, h), 0.02, TOP_AXES["embed"])
        if model.final_norm is not None:
            model.final_norm.fill_(1.0)
        if not cfg.tie_word_embeddings:
            fill(model.lm_head, (h, V), 1.0 / math.sqrt(h), TOP_AXES["lm_head"])
    return model


def _from_numpy(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def params_from_jax(cfg: ModelConfig, tree: Dict, dtype=None,
                    device=None, rank: int = 0, tp: int = 1, stage: int = 0,
                    pp: int = 1) -> Llama:
    """The port's model from a JAX `init_params` / `load_params` tree
    already converted to numpy (``jax.tree.map(np.asarray, params)``):
    layer stacks [L, ...] become per-layer parameters, and int8
    ``{"q", "s"}`` leaves (after JAX `quantize_params`) stay quantized,
    with a tied model's added ``lm_head``.  `dtype` defaults to the tree's
    own (bf16 arrays arrive as ml_dtypes and go through f32).  With
    ``tp`` > 1, rank `rank`'s shard: the numpy leaves are sliced as JAX's
    `param_pspecs` / `quantize_pspecs` place them (`parallel.
    shard_params`) before anything reaches the device; with ``pp`` > 1,
    stage `stage`'s layers, the stacked layer axis split over pp as JAX's
    `param_pspecs_pp` splits it."""
    if tp > 1 or pp > 1:
        tree = shard_params(tree, cfg, rank, tp, stage, pp)
    embed = _from_numpy(tree["embed"]) if "embed" in tree else None
    model = Llama(cfg, dtype=dtype or _tree_dtype(tree, embed), device=device,
                  rank=rank, tp=tp, stage=stage, pp=pp)
    dev = model.device
    layers = tree["layers"]
    unknown = set(layers) - set(layer_keys(cfg))
    missing = set(layer_keys(cfg)) - set(layers)
    if unknown or missing:
        raise KeyError(f"{cfg.name}: tree layers differ from the config: "
                       f"unknown {sorted(unknown)}, missing {sorted(missing)}")

    def quant(leaf, i=None):
        q, s = _from_numpy(leaf["q"]), _from_numpy(leaf["s"])
        if i is not None:
            q, s = q[i], s[i]
        return {"q": q.to(dev), "s": s.float().to(dev)}

    with torch.no_grad():
        if model.embed is not None:
            model.embed.copy_(embed)
        if model.final_norm is not None:
            model.final_norm.copy_(_from_numpy(tree["final_norm"]))
        head = tree.get("lm_head")
        if is_quantized(head):
            _swap(model, "lm_head", quant(head))
        elif model.lm_head is not None:
            model.lm_head.copy_(_from_numpy(head))
        for name, leaf in layers.items():
            if is_quantized(leaf):
                for i, layer in enumerate(model.layers):
                    _swap(layer, name, quant(leaf, i))
                continue
            stacked = _from_numpy(leaf)
            for i, layer in enumerate(model.layers):
                getattr(layer, name).copy_(stacked[i])
    return model


def _tree_dtype(tree: Dict, embed) -> torch.dtype:
    """A tree's own dtype: its embedding's, or on a stage without one its
    first unquantized layer leaf's."""
    if embed is not None:
        return embed.dtype
    for name in ("attn_norm", "wq"):
        leaf = tree["layers"][name]
        if not is_quantized(leaf):
            return _from_numpy(leaf).dtype
    raise ValueError("a stage tree without an unquantized leaf")


@torch.no_grad()
def shard_model(full: Llama, rank: int, tp: int, device=None, stage: int = 0,
                pp: int = 1) -> Llama:
    """Rank `rank`'s shard of stage `stage`'s layers of an unquantized
    flat model (one the loader read onto the CPU), on `device`."""
    cfg = full.cfg
    model = Llama(cfg, dtype=full.dtype, device=device, rank=rank, tp=tp,
                  stage=stage, pp=pp)
    axes = param_shard_axes(cfg)
    for i, dst in zip(model.layer_range, model.layers):
        src = full.layers[i]
        for name in layer_keys(cfg):
            getattr(dst, name).copy_(shard(getattr(src, name), axes[name],
                                           rank, tp))
    if model.embed is not None:
        model.embed.copy_(shard(full.embed, TOP_AXES["embed"], rank, tp))
    if model.final_norm is not None:
        model.final_norm.copy_(full.final_norm)
    if model.lm_head is not None:
        model.lm_head.copy_(shard(full.lm_head, TOP_AXES["lm_head"], rank, tp))
    return model

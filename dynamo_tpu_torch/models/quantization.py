"""Weight-only int8 quantization for serving: the port of the JAX
package's `models/quantization.py`.

A quantized weight is ``{"q": int8 [..., in, out], "s": f32 [out]}`` (the
JAX layout: symmetric, one scale per output channel), and it takes the
place of the bf16 parameter in its layer.  `matmul_any` takes either form.

Decode is bound by weight bytes, so int8 halves what a step must read;
here the product still runs as dequantize-then-`torch.matmul` (the int8
cast to the activation dtype, the product kept in f32, then the scale),
which reads more bytes than bf16 until a W8A16 kernel replaces it.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

# weights quantized when their name matches (per layer); norms, router and
# embeddings stay high-precision (embedding is a lookup; router logits are
# tiny and drive discrete top-k choices)
QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def is_quantized(w: Any) -> bool:
    return isinstance(w, dict) and "q" in w


def quantize_tensor(w: torch.Tensor, stacked: bool = False,
                    group=None) -> Dict[str, torch.Tensor]:
    """Symmetric per-output-channel int8 (last axis = output channels),
    bit-equal to the JAX function: the absmax in f32, scale = max(absmax,
    1e-8) / 127, q = clip(round-half-even(w / scale), -127, 127).
    `stacked` keeps the leading (layer) axis: scales come out [L, out].
    `group`: `w` is one rank's row shard of a weight split on its input
    axis; the absmax is taken over the whole input axis (a max over the
    ranks), so q is the slice of the whole weight's q and s its s."""
    first = 1 if stacked else 0
    reduce = tuple(range(first, w.ndim - 1))
    wf = w.float()
    absmax = wf.abs().amax(dim=reduce) if reduce else wf.abs()
    if group is not None:
        from ..parallel.collectives import all_reduce_max

        absmax = all_reduce_max(absmax.contiguous(), group)
    scale = torch.clamp(absmax, min=1e-8) / 127.0
    div = scale
    for ax in reduce:
        div = div.unsqueeze(ax)
    q = torch.clamp(torch.round(wf / div), -127, 127).to(torch.int8)
    return {"q": q, "s": scale.float()}


def dequantize_tensor(wq: Dict[str, torch.Tensor],
                      dtype=torch.bfloat16) -> torch.Tensor:
    q, s = wq["q"], wq["s"]
    for ax in range(s.ndim - 1, q.ndim - 1):
        s = s.unsqueeze(ax)
    return (q.float() * s).to(dtype)


def _mm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., in] @ w [in, out] in w's (= x's) dtype with an f32 result:
    f32 sums of exact products, like ``preferred_element_type=f32``.  On
    the card a bf16 product goes to cuBLAS with an f32 output (no bf16
    rounding before the caller's scale); on the CPU through f32."""
    if x.is_cuda and x.dtype == torch.bfloat16:
        y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], w.shape[-1])
    return x.float() @ w.float()


def matmul_any(x: torch.Tensor, w: Any) -> torch.Tensor:
    """x @ w over a plain weight or a quantized {"q", "s"} dict; f32 out.

    The int8 operand is cast to the activation dtype for the product and
    the per-channel scale applied to the f32 product, as the JAX function
    scales the f32 accumulator.  A plain weight gives ``(x @ w).float()``,
    the port's dense projections."""
    if not is_quantized(w):
        return (x @ w).float()
    return _mm_f32(x, w["q"].to(x.dtype)) * w["s"]


def _swap(module: torch.nn.Module, name: str, value) -> None:
    """Replace attribute `name` (a parameter or a quantized dict) by
    `value`, dropping the old one first so its memory can go."""
    if name in module._parameters:
        del module._parameters[name]
    elif hasattr(module, name):
        delattr(module, name)
    object.__setattr__(module, name, value)


@torch.no_grad()
def quantize_params(model) -> Any:
    """Quantize the projection weights of a `Llama` in place and return it:
    each layer's dense [in, out] projections (MoE expert stacks, 3-D per
    layer, stay high-precision for the grouped GEMM) and the LM head.  A
    tied model gets an int8 ``lm_head`` copy of ``embed.T`` (the embedding
    lookup keeps the original table).  One layer's weights are replaced at
    a time, so the model never holds two copies of all of them.  A tp
    shard (its group attached) quantizes as JAX quantizes the whole
    weight before sharding it: a row-parallel weight's scales come from
    the whole input axis (`quantize_tensor`'s `group`), a column-parallel
    one's are its own slice of them."""
    from ..parallel.sharding import param_shard_axes

    comm = model.comm
    axes = param_shard_axes(model.cfg)
    for layer in model.layers:
        for key in QUANT_KEYS:
            w = getattr(layer, key, None)
            if w is not None and not is_quantized(w) and w.dim() == 2:
                rows = comm.tp > 1 and axes[key] == 0
                _swap(layer, key, quantize_tensor(
                    w, group=comm.pg() if rows else None))
    if not model.last_stage:
        return model  # the head lives on the last pipeline stage
    head = model.lm_head
    if head is not None and not is_quantized(head):
        _swap(model, "lm_head", quantize_tensor(head))
    elif head is None:
        _swap(model, "lm_head", quantize_tensor(model.embed.t()))
    return model


def random_int8_params(cfg, generator: torch.Generator, device=None):
    """A `Llama` with random ALREADY-QUANTIZED dense projections and head,
    the layout `quantize_params` produces (int8 drawn in [-127, 127],
    scale 1 / (127 sqrt(in))), so the int8 serving path is the real one
    and no bf16 copy of the weights is ever made.  Norms are 1, the
    embedding bf16 with std 0.02.  Dense configs only, as in JAX.  The
    bf16 parameters it replaces are allocated but never filled, and go
    layer by layer."""
    from .llama import Llama

    if cfg.is_moe:
        raise ValueError("random_int8_params builds dense models only")
    model = Llama(cfg, dtype=torch.bfloat16, device=device)
    gdev = generator.device

    def qw(fan_in: int, fan_out: int):
        q = torch.randint(-127, 128, (fan_in, fan_out), generator=generator,
                          dtype=torch.int8, device=gdev)
        s = torch.full((fan_out,), 1.0 / (127 * math.sqrt(fan_in)),
                       dtype=torch.float32, device=gdev)
        return {"q": q.to(model.device), "s": s.to(model.device)}

    with torch.no_grad():
        for layer in model.layers:
            for key in QUANT_KEYS:
                _swap(layer, key, qw(*getattr(layer, key).shape))
            layer.attn_norm.fill_(1.0)
            layer.mlp_norm.fill_(1.0)
        emb = torch.randn(model.embed.shape, generator=generator,
                          dtype=torch.float32, device=gdev) * 0.02
        model.embed.copy_(emb.to(torch.bfloat16))
        model.final_norm.fill_(1.0)
        _swap(model, "lm_head", qw(cfg.hidden_size, cfg.vocab_size))
    return model

"""Which axis of each weight splits over tp, and each rank's shard.

Weights are replicated over dp and megatron-sharded over tp, as JAX's
`shard_params` places them (`dynamo_tpu/parallel/mesh.py:72-83`): every
replica of a dp x tp group builds the same tp shards.  Under pp a stage
holds its contiguous range of the stacked layers (JAX
`param_pspecs_pp`), each tp-sharded as above, and the top-level leaves
`stage_keys` names.

The port of `param_pspecs` (`dynamo_tpu/models/llama.py:146-206`),
`quantize_pspecs` (`dynamo_tpu/models/quantization.py:106`) and
`kv_cache_pspec` (`llama.py:209`), written as "the axis of this leaf
that splits over tp" (None: replicated) for the port's per-layer
parameters (no leading layer axis):

- q/k/v and their biases, and the sinks, split on heads (column
  parallel); ``wo`` on its input axis (row parallel), its bias ``bo``
  replicated and added once after the all-reduce;
- a dense MLP's gate and up on ffn, ``w_down`` on its input axis;
- MoE expert stacks and their biases on the expert axis (JAX's
  ``ep_axis="tp"``), the router and its bias replicated;
- ``embed`` and ``lm_head`` on the vocabulary;
- an int8 ``{"q", "s"}`` leaf: ``q`` like its weight, ``s`` on the
  weight's output axis (replicated for a row-parallel weight);
- the KV pool [L, P, page, n_kv, hd] on its kv heads (axis 3) over tp,
  and on its pages (axis 1) over dp when the pool is partitioned
  (`kv_pool_axes`).

Rank r holds the r-th of tp equal slices along that axis, so rank r's q
heads use exactly its kv heads (a group of q heads never straddles two
ranks).

The model sources (`SeededShards`, `TreeShards`, `CheckpointShards`)
say how each rank of an engine's group gets its shard (``source(rank,
tp, device, stage=0, pp=1)``); they are picklable, so a follower process
builds its own.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np

# per-layer leaf -> its tp axis in the port's layout ([in, out] weights)
_DENSE_AXES = {
    "wq": 1, "wk": 1, "wv": 1, "wo": 0, "attn_norm": None, "mlp_norm": None,
    "bq": 0, "bk": 0, "bv": 0, "bo": None, "sinks": 0,
    "w_gate": 1, "w_up": 1, "w_down": 0,
}
_MOE_AXES = {"router": None, "router_b": None, "w_gate": 0, "w_up": 0,
             "w_down": 0, "b_gate": 0, "b_up": 0, "b_down": 0}
TOP_AXES = {"embed": 0, "final_norm": None, "lm_head": 1}
# the KV pool [L, P, page, n_kv, hd] splits on kv heads over tp, and on
# pages over dp when partitioned
KV_HEAD_AXIS = 3
KV_PAGE_AXIS = 1


def kv_pool_axes(pooled: bool) -> Dict[int, Optional[str]]:
    """{pool axis: the mesh axis it splits over, or None}: the port's
    counterpart of JAX's `kv_cache_pspec(pool_axes=...)`
    (`dynamo_tpu/models/llama.py:209`).  The kv heads split over tp; the
    pages split over dp when the pool is partitioned (``kv_partition``:
    replica d holds global pages ``d * num_pages`` .. ``(d + 1) *
    num_pages - 1`` as its local 0 .., its local page 0 its trash page),
    and are replicated over dp otherwise (every replica holds every
    page, byte-equal)."""
    return {KV_PAGE_AXIS: "dp" if pooled else None, KV_HEAD_AXIS: "tp"}


def param_shard_axes(cfg) -> Dict[str, Optional[int]]:
    """{per-layer key: tp axis or None} for the layer keys of `cfg`."""
    from ..models.llama import layer_keys

    axes = dict(_DENSE_AXES)
    if cfg.is_moe:
        axes.update(_MOE_AXES)
    return {k: axes[k] for k in layer_keys(cfg)}


def quant_shard_axes(axis: Optional[int], ndim: int) -> Dict[str, Optional[int]]:
    """The axes of an int8 leaf whose weight (of `ndim` dims, last =
    output) splits on `axis`: q like the weight, the per-output scale on
    its one axis when the output axis splits."""
    return {"q": axis, "s": 0 if axis is not None and axis == ndim - 1 else None}


def check_divisible(cfg, tp: int) -> None:
    """Refuse a config that tp does not divide (JAX's messages,
    `dynamo_tpu/engine/engine.py:1396-1406`, `:1470-1482`)."""
    if tp <= 1:
        return
    dims = {"q heads": cfg.num_attention_heads,
            "kv heads": cfg.num_key_value_heads,
            "vocab_size": cfg.vocab_size}
    if cfg.is_moe:
        dims["num_experts"] = cfg.num_experts
    else:
        dims["intermediate_size"] = cfg.intermediate_size
    bad = [k for k, v in dims.items() if v % tp]
    if bad:
        raise ValueError(f"tp={tp} must evenly divide {', '.join(bad)} "
                         f"({cfg.name})")


def shard(a, axis: Optional[int], rank: int, tp: int):
    """Rank `rank`'s slice of `a` (numpy or torch) along `axis`."""
    if axis is None or tp == 1:
        return a
    n = a.shape[axis] // tp
    idx = [slice(None)] * a.ndim
    idx[axis] = slice(rank * n, (rank + 1) * n)
    return a[tuple(idx)]


def kv_shard_heads(n_kv: int, rank: int, tp: int) -> range:
    """The kv heads of the pool that rank `rank` holds."""
    n = n_kv // tp
    return range(rank * n, (rank + 1) * n)


def _is_quant(leaf) -> bool:
    return isinstance(leaf, dict) and "q" in leaf


def stage_keys(cfg, stage: int, pp: int) -> set:
    """The top-level (non-layer) keys a pipeline stage holds: the
    embedding on stage 0 (and on the last stage for a tied head), the
    final norm and the LM head on the last stage."""
    keys = set()
    if stage == 0:
        keys.add("embed")
    if stage == pp - 1:
        keys |= {"final_norm", "lm_head"}
        if cfg.tie_word_embeddings:
            keys.add("embed")
    return keys


def shard_params(tree: Dict[str, Any], cfg, rank: int, tp: int,
                 stage: int = 0, pp: int = 1) -> Dict[str, Any]:
    """Rank `rank`'s shard of a JAX-layout tree (``layers`` leaves stacked
    [L, ...]; int8 ``{"q", "s"}`` leaves, a tied model's quantized
    ``lm_head`` included, as JAX `quantize_pspecs` places them); with
    ``pp`` > 1 stage `stage`'s part: the stacked layer axis split over pp
    (JAX `param_pspecs_pp`, `dynamo_tpu/parallel/pp_engine.py:54-80`) and
    the top-level leaves of `stage_keys`."""
    check_divisible(cfg, tp)
    axes = param_shard_axes(cfg)
    n = cfg.num_hidden_layers // pp
    lo = stage * n

    def leaf(a, axis, stacked):
        off = 1 if stacked else 0
        if _is_quant(a):
            q = np.asarray(a["q"])
            qa = quant_shard_axes(axis, q.ndim - off)
            return {k: shard(_stage(np.asarray(a[k]), stacked),
                             None if qa[k] is None else qa[k] + off, rank, tp)
                    for k in ("q", "s")}
        return shard(_stage(np.asarray(a), stacked),
                     None if axis is None else axis + off, rank, tp)

    def _stage(a, stacked):
        return a[lo:lo + n] if stacked else a

    keep = stage_keys(cfg, stage, pp)
    out = {k: leaf(v, TOP_AXES[k], False) for k, v in tree.items()
           if k in keep}
    out["layers"] = {k: leaf(v, axes[k], True)
                     for k, v in tree["layers"].items()}
    return out


# --------------------------------------------------------------------------- #
# model sources: how each rank of an engine's tp group gets its shard
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class SeededShards:
    """A rank's shard of `init_params(cfg, Generator(device).manual_seed(
    seed))`, the flat model's values (each tensor is drawn whole on the
    rank's device and sliced, one at a time), optionally `sharpen`ed."""

    cfg: Any
    seed: int
    dtype: str = "bfloat16"
    sharpen: bool = False

    def __call__(self, rank: int, tp: int, device, stage: int = 0,
                 pp: int = 1):
        import torch

        from ..models.llama import init_params

        gen = torch.Generator(device=device).manual_seed(self.seed)
        model = init_params(self.cfg, gen, dtype=getattr(torch, self.dtype),
                            device=device, rank=rank, tp=tp, stage=stage,
                            pp=pp)
        if self.sharpen:
            from ..testing import sharpen

            with torch.no_grad():
                sharpen(model)
        return model


@dataclass(frozen=True)
class TreeShards:
    """A rank's shard of a JAX tree saved with `save_tree` (an ``.npz``
    of its numpy leaves), through `params_from_jax`."""

    cfg: Any
    path: str
    dtype: Optional[str] = None

    def __call__(self, rank: int, tp: int, device, stage: int = 0,
                 pp: int = 1):
        import torch

        from ..models.llama import params_from_jax

        tree = load_tree(self.path)
        return params_from_jax(
            self.cfg, tree, dtype=getattr(torch, self.dtype) if self.dtype
            else None, device=device, rank=rank, tp=tp, stage=stage, pp=pp)


@dataclass(frozen=True)
class CheckpointShards:
    """A rank's shard of an HF checkpoint directory: the port's loader
    reads it onto the CPU, then the rank keeps its slices.  `prefix`
    namespaces the LLM's tensor names (a re-nested Qwen-VL checkpoint's
    ``model.language_``)."""

    cfg: Any
    path: str
    dtype: str = "bfloat16"
    prefix: str = ""

    def __call__(self, rank: int, tp: int, device, stage: int = 0,
                 pp: int = 1):
        import torch

        from ..models.llama import shard_model
        from ..models.loader import load_params

        full = load_params(self.path, self.cfg, dtype=getattr(torch, self.dtype),
                           prefix=self.prefix, device="cpu")
        return shard_model(full, rank, tp, device, stage, pp)


def save_tree(path: str, tree: Dict[str, Any]) -> None:
    """Write a numpy tree (``jax.tree.map(np.asarray, params)``) as one
    ``.npz``, keys joined by ``/``; bf16 leaves go as f32."""
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}{k}/", v)
            return
        a = np.asarray(node)
        if a.dtype.name == "bfloat16":
            a = a.astype(np.float32)
        flat[prefix[:-1]] = a

    walk("", tree)
    np.savez(path, **flat)


def load_tree(path: str) -> Dict[str, Any]:
    """The tree `save_tree` wrote."""
    out: Dict[str, Any] = {}
    with np.load(path) as f:
        for key in f.files:
            node = out
            *parents, last = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[last] = f[key]
    return out

"""Sequence-parallel prefill: a prompt's uncached remainder sharded over the
sp slots of a replica, attention as ring attention (the port of JAX
`dynamo_tpu/parallel/sp_prefill.py`, `forward_prefill_sp` / `_layer_sp`).

Each slot of a (dp, sp, tp) group holds S/sp of the chunk and every layer
(each tensor rank its tp shard of them, as the flat tp path).  Per layer:

- q, k, v of the slot's tokens at their global positions ``prefix + slot
  * S/sp + j`` (rope and every mask use them);
- ring attention over the sp ring (`parallel/ring_attention.py`), the
  cached prefix folded first from the pool pages;
- the pool write: the chunk's K/V gathered over the sp group
  (`collectives.gather_seq`) and written at the row's prefix offset.  On
  a replicated pool every slot writes every row of its replica's block
  (the replicas then level as under dp, `TorchEngine._sync_replicas`), so
  every replica holds the same bytes; on a pool partitioned over (dp, sp)
  only the row's owner slot (``owner``) writes it, at local ids, the
  others into their trash page 0;
- the output projection (tp all-reduce, then ``bo``) and the MLP or the
  MoE under tp, as the flat tp path computes them.

The last position: each slot offers its masked candidate for a row's last
valid hidden state and an O(h) sum over the sp group picks it (JAX
`sp_prefill.py:375-382`), then the tp-sharded LM head runs as today
(`Llama.lm_logits`).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops import rms_norm
from ..ops.paged_attention import kv_slots, write_kv_slots
from ..ops.rotary import rope_cos_sin, rotate
from .collectives import all_reduce_sum, gather_seq
from .ring_attention import Ring, ring_attention_local


def _layer_sp(layer, x, kv_layer, rope, ring: Ring, group, slot, prefix,
              prefix_arg):
    """One decoder layer on the slot's [B, Sl, h] shard: ring attention,
    the pool write of the sp-gathered chunk at `slot`, the tp reductions
    of the flat tp path."""
    B, Sl, _ = x.shape
    k_pages, v_pages = kv_layer
    attn_in = rms_norm(x, layer.attn_norm, layer.cfg.rms_norm_eps)
    q, k, v = layer._qkv(attn_in)
    q, k = rotate(q, *rope), rotate(k, *rope)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    window, sink = layer._attn_extras()
    attn = ring_attention_local(
        q, k, v, ring, causal=True, q_offset=prefix, window=window, sink=sink,
        prefix=None if prefix_arg is None else (k_pages, v_pages, *prefix_arg))
    if group is not None and group.sp > 1:
        k, v = gather_seq(k, group), gather_seq(v, group)
    write_kv_slots(k_pages, v_pages, slot, k, v)
    x = x + layer._attn_out(attn.reshape(B, Sl, -1))
    return x + layer._mlp(rms_norm(x, layer.mlp_norm, layer.cfg.rms_norm_eps))


def last_hidden_sp(x: torch.Tensor, chunk: torch.Tensor, group) -> torch.Tensor:
    """Each row's hidden state at its last valid chunk position [B, h]:
    the slot holding it offers it, the others zeros, summed over the sp
    group (exact: one nonzero term)."""
    B, Sl, _ = x.shape
    i = 0 if group is None else group.sp_rank
    last = torch.clamp(chunk.long() - 1, min=0)
    own = (last // Sl) == i
    idx = torch.clamp(last - i * Sl, 0, Sl - 1)
    cand = x[torch.arange(B, device=x.device), idx]
    cand = torch.where(own[:, None], cand, torch.zeros_like(cand))
    if group is None or group.sp == 1:
        return cand
    return all_reduce_sum(cand.contiguous(), group.sp_group)


@torch.no_grad()
def forward_prefill_sp(model, group, kv, tokens: torch.Tensor,
                       table: torch.Tensor, prefix: torch.Tensor,
                       chunk: torch.Tensor, owner: Optional[torch.Tensor] = None,
                       prefix_pages: int = 0) -> torch.Tensor:
    """Whole-remainder prefill of this replica's rows with the sequence
    sharded over the sp slots: tokens [B, S] (S a multiple of sp; each
    slot takes its S/sp columns), table [B, W] (local ids on a partitioned
    pool), prefix and chunk [B] int32.  ``owner`` [B]: on a partitioned
    pool, the sp slot owning each row's pages (only it writes them).
    ``prefix_pages``: the table columns covering the longest cached prefix
    (0: no row has one, and the prefix fold is skipped).  Returns the f32
    logits [B, V] at each row's last valid position, on every slot."""
    ring = Ring(group if group is not None and group.sp > 1 else None)
    B, S = tokens.shape
    n, i = ring.size, ring.slot
    if S % n:
        raise ValueError(f"a chunk of {S} tokens does not split over sp={n}")
    Sl = S // n
    dev = tokens.device
    prefix = prefix.to(torch.int32)
    positions = (prefix.long()[:, None] + i * Sl
                 + torch.arange(Sl, device=dev)[None, :])
    rope = (*rope_cos_sin(positions, model.inv_freq), model.rope_scale)
    write_table = table
    if owner is not None:
        write_table = torch.where((owner == i)[:, None], table,
                                  torch.zeros_like(table))
    slot = kv_slots(write_table, prefix, chunk, S, kv.page_size)
    prefix_arg = None
    if prefix_pages:
        prefix_arg = (table[:, :prefix_pages].contiguous(), prefix)
    x = model._embed(tokens[:, i * Sl:(i + 1) * Sl])
    for li, layer in enumerate(model.layers):
        x = _layer_sp(layer, x, (kv.k[li], kv.v[li]), rope, ring, group, slot,
                      prefix, prefix_arg)
    return model.lm_logits(last_hidden_sp(x, chunk, group))

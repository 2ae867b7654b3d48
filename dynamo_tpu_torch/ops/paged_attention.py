"""Paged attention over the KV page pool.

- The pool of one layer is ``[num_pages, page_size, n_kv_heads, head_dim]``;
  a sequence owns an ordered list of page ids (its page-table row).  Page 0
  is the trash page: padding tokens write there.
- ``prefill_attention``: a new chunk attends to its cached prefix pages,
  then to itself causally.  ``decode_attention``: one new token per
  sequence over its page-table row, the new token's KV already written.

On a CUDA tensor the public functions launch the hand-written kernels
(`cuda_attention.py`); on a CPU tensor they run the plain PyTorch versions
below, which follow the JAX package's einsum path
(`dynamo_tpu/ops/paged_attention.py`).  There is no size-based switch
between the two: on the card attention always goes through the kernels.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def kv_slots(page_table: torch.Tensor, write_pos: torch.Tensor,
             chunk_lens: torch.Tensor, S: int, page: int) -> torch.Tensor:
    """Flat pool slot [B*S] of each token of a chunk written at `write_pos`;
    padding tokens (at or past chunk_len) map to slot 0 of trash page 0.
    The same for every layer, so computed once per step."""
    ar = torch.arange(S, device=page_table.device)
    pos = write_pos.long()[:, None] + ar[None, :]
    valid = ar[None, :] < chunk_lens.long()[:, None]
    page_idx = torch.clamp(pos // page, 0, page_table.shape[1] - 1)
    page_ids = torch.gather(page_table.long(), 1, page_idx)
    return torch.where(valid, page_ids * page + pos % page,
                       torch.zeros_like(pos)).reshape(-1)


def write_kv_slots(k_pages, v_pages, slot, k_new, v_new) -> None:
    """Scatter k_new/v_new [B, S, n_kv, hd] into the pool at `slot`, in
    place."""
    P, page, n_kv, hd = k_pages.shape
    k_pages.view(P * page, n_kv, hd).index_copy_(
        0, slot, k_new.reshape(-1, n_kv, hd).to(k_pages.dtype))
    v_pages.view(P * page, n_kv, hd).index_copy_(
        0, slot, v_new.reshape(-1, n_kv, hd).to(v_pages.dtype))


def write_kv_pages(
    k_pages: torch.Tensor,  # [P, page, n_kv, hd] — updated in place
    v_pages: torch.Tensor,
    k_new: torch.Tensor,  # [B, S, n_kv, hd]
    v_new: torch.Tensor,
    page_table: torch.Tensor,  # [B, max_pages] int32
    write_pos: torch.Tensor,  # [B] — sequence offset where this chunk starts
    chunk_lens: torch.Tensor,  # [B] — valid tokens in this chunk
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter a new KV chunk into the pool, in place (the JAX version
    returns new arrays; here the pool is updated where it lies).  Padding
    tokens go to trash page 0."""
    slot = kv_slots(page_table, write_pos, chunk_lens, k_new.shape[1],
                    k_pages.shape[1])
    write_kv_slots(k_pages, v_pages, slot, k_new, v_new)
    return k_pages, v_pages


def gather_kv(
    k_pages: torch.Tensor, v_pages: torch.Tensor, page_table: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Materialize each sequence's KV: [B, max_pages*page, n_kv, hd]."""
    idx = page_table.long()
    k, v = k_pages[idx], v_pages[idx]  # [B, mp, page, n_kv, hd]
    B, mp, page, n_kv, hd = k.shape
    return k.reshape(B, mp * page, n_kv, hd), v.reshape(B, mp * page, n_kv, hd)


def _mqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q [B, Sq, H, hd] x k [B, Sk, n_kv, hd] -> f32 [B, H, Sq, Sk]."""
    B, Sq, H, hd = q.shape
    n_kv = k.shape[2]
    qg = q.float().reshape(B, Sq, n_kv, H // n_kv, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float())
    return s.reshape(B, H, Sq, k.shape[1])


def _mqa_out(weights: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """f32 weights [B, H, Sq, Sk] x v [B, Sk, n_kv, hd] -> f32 [B, Sq, H, hd]."""
    B, H, Sq, Sk = weights.shape
    n_kv = v.shape[2]
    wg = weights.reshape(B, n_kv, H // n_kv, Sq, Sk)
    out = torch.einsum("bkgqs,bskd->bqkgd", wg, v.float())
    return out.reshape(B, Sq, H, v.shape[3])


def _sink_softmax(scores: torch.Tensor, valid: torch.Tensor,
                  sink: Optional[torch.Tensor]) -> torch.Tensor:
    """Masked softmax over the last axis with optional per-head sink
    logits (scores [B, H, Sq, Sk]): the sink joins the denominator as a
    virtual key with no value.  Rows with no valid key get zero weights
    (the kernels' 1e-30 denominator clamp gives zeros there too)."""
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    if sink is not None:
        col = sink.float().reshape(1, -1, 1, 1).expand(*scores.shape[:-1], 1)
        scores = torch.cat([scores, col], dim=-1)
    w = torch.softmax(scores, dim=-1)
    if sink is not None:
        w = w[..., :-1]
    return w * valid.any(dim=-1, keepdim=True)


def prefill_attention_plain(
    q: torch.Tensor,  # [B, S, H, hd]
    k_new: torch.Tensor,  # [B, S, n_kv, hd]
    v_new: torch.Tensor,
    k_pages: torch.Tensor,  # [P, page, n_kv, hd]
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # [B, max_pages]
    prefix_lens: torch.Tensor,  # [B]
    chunk_lens: torch.Tensor,  # [B]
    window: Optional[int] = None,
    sink: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    B, S, H, hd = q.shape
    dev = q.device
    scale = 1.0 / math.sqrt(hd)
    win = 0 if window is None else int(window)
    k_pre, v_pre = gather_kv(k_pages, v_pages, page_table)
    Lp = k_pre.shape[1]
    i = torch.arange(S, device=dev)[None, None, :, None]
    q_pos = prefix_lens.long()[:, None, None, None] + i

    p = torch.arange(Lp, device=dev)[None, None, None, :]
    pre_valid = p < prefix_lens.long()[:, None, None, None]
    if win > 0:
        pre_valid = pre_valid & (p > q_pos - win)
    j = torch.arange(S, device=dev)[None, None, None, :]
    new_valid = (j <= i) & (j < chunk_lens.long()[:, None, None, None])
    if win > 0:
        new_valid = new_valid & (j > i - win)

    scores = torch.cat(
        [_mqa_scores(q, k_pre), _mqa_scores(q, k_new)], dim=-1) * scale
    valid = torch.cat([pre_valid.expand(B, H, S, Lp),
                       new_valid.expand(B, H, S, S)], dim=-1)
    w = _sink_softmax(scores, valid, sink)
    out = _mqa_out(w[..., :Lp], v_pre) + _mqa_out(w[..., Lp:], v_new)
    return out.to(q.dtype)


def decode_attention_plain(
    q: torch.Tensor,  # [B, H, hd]
    k_pages: torch.Tensor,  # [P, page, n_kv, hd] (new token already written)
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # [B, max_pages]
    seq_lens: torch.Tensor,  # [B] incl. the new token
    window: Optional[int] = None,
    sink: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    B, H, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    k, v = gather_kv(k_pages, v_pages, page_table)
    L = k.shape[1]
    scores = _mqa_scores(q[:, None], k) * scale  # [B, H, 1, L]
    pos = torch.arange(L, device=q.device)[None, None, None, :]
    sl = seq_lens.long()[:, None, None, None]
    valid = pos < sl
    if window is not None and int(window) > 0:
        valid = valid & (pos >= sl - int(window))
    w = _sink_softmax(scores, valid.expand(B, H, 1, L), sink)
    return _mqa_out(w, v)[:, 0].to(q.dtype)


def decode_attention_split_plain(
    q: torch.Tensor,  # [B, H, hd]
    k_pages: torch.Tensor,  # [P, page, n_kv, hd]
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # [B, max_pages]
    seq_lens: torch.Tensor,  # [B]
    window: Optional[int] = None,
    sink: Optional[torch.Tensor] = None,
    n_split: int = 1,
    split_pages: Optional[int] = None,
) -> torch.Tensor:
    """`decode_attention_plain` computed as the CUDA split-KV kernel pair
    computes it: the row's keys are cut into `n_split` runs of
    `split_pages` pages (by default ceil(max_pages / n_split); the kernel
    takes a constant, `cuda_attention.decode_split_pages`, and enough
    splits to cover the table); each split keeps its own f32 (max m,
    denominator l, accumulator acc) -- m = NEG_INF and l = 0 for a split
    with no visible key -- and the merge rescales the splits by exp(m - M)
    against their
    common maximum M, adds the sink to the denominator only and clamps it
    to 1e-30.  Returns [B, H, hd]."""
    B, H, hd = q.shape
    page = k_pages.shape[1]
    maxp = page_table.shape[1]
    if split_pages is None:
        split_pages = -(-maxp // n_split)
    sk = split_pages * page
    k, v = gather_kv(k_pages, v_pages, page_table)
    L = k.shape[1]
    pad = n_split * sk - L
    if pad < 0:
        raise ValueError(f"{n_split} splits of {split_pages} pages do not "
                         f"cover a table of {maxp} pages")
    k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
    v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    scores = _mqa_scores(q[:, None], k)[:, :, 0] / math.sqrt(hd)  # [B, H, Lp]
    pos = torch.arange(n_split * sk, device=q.device)[None, None, :]
    sl = seq_lens.long()[:, None, None]
    valid = pos < sl
    if window is not None and int(window) > 0:
        valid = valid & (pos >= sl - int(window))
    valid = valid.expand(B, H, -1)
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    s = scores.reshape(B, H, n_split, sk)
    ok = valid.reshape(B, H, n_split, sk)
    m = s.amax(-1)  # [B, H, n_split]; NEG_INF for an empty split
    p = torch.where(ok, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = p.sum(-1)
    n_kv = v.shape[2]
    vs = v.float().reshape(B, n_split, sk, n_kv, hd)
    acc = torch.einsum("bkgns,bnskd->bkgnd",
                       p.reshape(B, n_kv, H // n_kv, n_split, sk), vs)
    acc = acc.reshape(B, H, n_split, hd)
    # the merge pass
    M = m.amax(-1, keepdim=True)
    w = torch.where(m > 0.5 * NEG_INF, torch.exp(m - M), torch.zeros_like(m))
    den = (l * w).sum(-1)
    if sink is not None:
        den = den + torch.exp(sink.float()[None, :] - M[..., 0])
    out = (acc * w[..., None]).sum(-2) / den.clamp_min(1e-30)[..., None]
    return out.to(q.dtype)


def prefill_attention(q, k_new, v_new, k_pages, v_pages, page_table,
                      prefix_lens, chunk_lens, window=None, sink=None):
    """Chunk attends to its cached prefix + itself (causal; optionally
    only the last `window` positions). Returns [B, S, H, hd]."""
    if q.is_cuda:
        from .cuda_attention import prefill_attention_cuda

        return prefill_attention_cuda(
            q, k_new, v_new, k_pages, v_pages, page_table, prefix_lens,
            chunk_lens, window=window, sink=sink)
    return prefill_attention_plain(
        q, k_new, v_new, k_pages, v_pages, page_table, prefix_lens,
        chunk_lens, window=window, sink=sink)


def decode_attention(q, k_pages, v_pages, page_table, seq_lens,
                     window=None, sink=None):
    """Single-token attention over the page table. Returns [B, H, hd]."""
    if q.is_cuda:
        from .cuda_attention import decode_attention_cuda

        return decode_attention_cuda(q, k_pages, v_pages, page_table,
                                     seq_lens, window=window, sink=sink)
    return decode_attention_plain(q, k_pages, v_pages, page_table, seq_lens,
                                  window=window, sink=sink)

"""Pipeline parallelism of the serving engine: the layer stack staged over
the pp ranks of a group, each rank running the tick loop of its own stage
in Python (the counterpart of JAX `dynamo_tpu/parallel/pipeline.py` and
`pp_engine.py`, whose SPMD program runs every stage's tick at once under
`shard_map` and moves activations with `lax.ppermute`).

- a stage's model holds its contiguous L/S layers and its pool those
  layers' KV pages (`models/llama.py`, ``Llama(..., stage, pp)``);
- `forward_prefill_pp` is the GPipe prefill (JAX `pp_engine.py:139-237`):
  one chunk row of the rank's replica block a microbatch, over B + S - 1
  ticks, stage s handling row t - s; the last stage keeps each row's
  last-position hidden state and computes the logits;
- `forward_decode_pp` is the full decode ring (JAX `:240-433`): the rows
  split into S microbatches over T*M + S - 1 ticks; the last stage
  samples (greedy, seeded threefry at ``ctr + step``, the penalty
  histograms it carries, top-logprobs) and ships each row's next token
  id to stage 0, which embeds it as that row's next input, so every stage
  is busy in the steady state;
- `forward_embed_pp` runs `forward_embed` through the stages (JAX's
  `embed` under pp, `dynamo_tpu/engine/engine.py:4462-4474`).

Activations and token ids move between adjacent stages through
`collectives.stage_handoff` (a broadcast inside each pair of adjacent
stages, ordered so the ring cannot deadlock).  A stage skips its bubble
ticks outright, where JAX's SPMD stages compute into their trash page
and mask the result: nothing a bubble tick computes reaches an output
or a live page, so skipping it changes no token and no KV byte.

One stage (``group`` None, or a group of pp 1) is the same code without
handoffs, one microbatch holding every row: the flat engine's shapes, so
its results are the flat model's bit for bit.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..ops.sampling import (
    SamplingParams,
    apply_penalties,
    compute_logprobs,
    sample_tokens_maybe_greedy,
    top_logprobs,
)
from .collectives import stage_handoff


def _stages(group) -> tuple:
    """(stage, stages) of this rank: (0, 1) without a pp group."""
    if group is None or group.pp == 1:
        return 0, 1
    return group.stage, group.pp


@torch.no_grad()
def forward_prefill_pp(model, group, kv, tokens, table, prefix, chunk
                       ) -> Optional[torch.Tensor]:
    """The GPipe prefill of this rank's rows (tokens [B, S], table [B, W],
    prefix and chunk [B]): f32 logits [B, V] at each row's last valid
    position on the last stage, None on the others.  Each stage writes its
    layers' KV of every row."""
    from ..models.llama import last_positions

    s, S = _stages(group)
    if S == 1:
        x = model.stage_prefill(kv, tokens, table, prefix, chunk)
        return model.lm_logits(last_positions(x, chunk))
    B, width = tokens.shape
    h = model.cfg.hidden_size
    last = []
    for t in range(B + S - 1):
        m = t - s  # the row (microbatch) this stage handles at tick t
        if not 0 <= m < B:
            continue  # a bubble tick: nothing to compute or hand off
        x = None
        if s > 0:
            x = torch.empty((1, width, h), dtype=model.dtype,
                            device=tokens.device)
            stage_handoff(group, recv=x)
        r = slice(m, m + 1)
        out = model.stage_prefill(kv, tokens[r], table[r], prefix[r],
                                  chunk[r], x=x)
        if s < S - 1:
            stage_handoff(group, send=out)
        else:
            last.append(last_positions(out, chunk[r]))
    return model.lm_logits(torch.cat(last)) if s == S - 1 else None


def pack_steps(out, logp, ids=None, lps=None) -> torch.Tensor:
    """`blocks.pack_out` of every step at once: out, logp [T, B] (and the
    top ids, logprobs [T, B, K]) -> packed [T, P]."""
    from ..engine.blocks import _bits

    parts = [_bits(out), logp.float()]
    if ids is not None:
        parts += [_bits(ids).flatten(1), lps.float().flatten(1)]
    return torch.cat(parts, dim=-1)


@torch.no_grad()
def forward_decode_pp(model, group, kv, inp: Dict[str, torch.Tensor],
                      n_steps: int, max_valid_pos: int, variant,
                      top_k: int = 0) -> Optional[torch.Tensor]:
    """`n_steps` decode steps of this rank's rows with the pipeline kept
    full.  `inp` holds the decode block's inputs (tok, pos, ctr [B],
    table [B, W], seeds, the sampling columns; counts [B, V] when
    `variant.penalized`); B must split into S microbatches.  Returns the
    packed results [n_steps, P] (`blocks.pack_out`'s layout, with
    `top_k` top ids and logprobs when `variant.with_top`) on the last
    stage, None on the others.

    Row i of microbatch mb at step j runs at position ``pos[i] + j`` (a
    row past `max_valid_pos` writes through an all-trash table row at
    position 0, as `blocks._masked_step`) and samples with counter
    ``ctr[i] + j``; its penalty histogram lives on the last stage, which
    updates it before the microbatch's next step arrives M ticks later."""
    from ..engine.blocks import SAMP_COLUMNS

    s, S = _stages(group)
    tok, pos, ctr, table = inp["tok"], inp["pos"], inp["ctr"], inp["table"]
    B = tok.shape[0]
    M = S  # the microbatches: one in flight a stage
    if B % M:
        raise ValueError(f"{B} decode rows do not split into {M} microbatches")
    Bm, T = B // M, n_steps
    dev = tok.device
    last = s == S - 1
    rows = [slice(mb * Bm, (mb + 1) * Bm) for mb in range(M)]
    # stage 0: each microbatch's input tokens of its next step
    feed = [tok[r] for r in rows]
    if last:
        out = torch.zeros((T, B), dtype=torch.int64, device=dev)
        logp = torch.zeros((T, B), dtype=torch.float32, device=dev)
        with_top = variant.with_top
        if with_top:
            ids = torch.zeros((T, B, top_k), dtype=torch.int32, device=dev)
            lps = torch.zeros((T, B, top_k), dtype=torch.float32, device=dev)
        counts = inp["counts"].clone() if variant.penalized else None
    state = None  # the hidden states handed in at the end of the last tick
    h = model.cfg.hidden_size
    for t in range(T * M + S - 1):
        g = t - s
        send = None
        if 0 <= g < T * M:
            mb, step = g % M, g // M
            r = rows[mb]
            p = pos[r] + step
            ok = p < max_valid_pos
            safe = torch.where(ok, p, torch.zeros_like(p))
            tbl = torch.where(ok[:, None], table[r], torch.zeros_like(table[r]))
            x = model.stage_decode(kv, feed[mb] if s == 0 else None, safe, tbl,
                                   x=None if s == 0 else state)
            if not last:
                send = x
            else:
                logits = model.lm_logits(x)
                if variant.penalized:
                    logits = apply_penalties(logits, counts[r], inp["fp"][r],
                                             inp["pp"][r])
                mb_samp = SamplingParams(*(inp[c][r] for c in SAMP_COLUMNS))
                nxt = sample_tokens_maybe_greedy(logits, mb_samp,
                                                 inp["seeds"][r],
                                                 ctr[r] + step,
                                                 variant.greedy)
                if variant.penalized:
                    counts[r] = counts[r].scatter_add(
                        1, nxt[:, None], torch.ones_like(counts[r][:, :1]))
                out[step, r] = nxt
                logp[step, r] = compute_logprobs(logits, nxt)
                if with_top:
                    ids[step, r], lps[step, r] = top_logprobs(logits, top_k)
                if step < T - 1:
                    if S == 1:
                        feed[mb] = nxt
                    else:
                        send = nxt  # the ring: back to stage 0
        if S == 1:
            continue
        # what the previous stage hands this one at the end of tick t
        gp = t - (s - 1 if s > 0 else S - 1)
        recv = None
        if 0 <= gp < T * M and (s > 0 or gp // M < T - 1):
            recv = (torch.empty((Bm, h), dtype=model.dtype, device=dev)
                    if s > 0 else torch.empty((Bm,), dtype=torch.int64,
                                              device=dev))
        stage_handoff(group, send=send, recv=recv)
        if recv is not None:
            if s > 0:
                state = recv
            else:
                feed[gp % M] = recv
    if not last:
        return None
    return pack_steps(out, logp, *((ids, lps) if with_top else ()))


@torch.no_grad()
def forward_embed_pp(model, group, tokens, lens) -> Optional[torch.Tensor]:
    """`Llama.forward_embed` through the stages (tokens [B, S], lens [B]):
    the rows pass stage after stage in one piece; f32 [B, h] on the last
    stage, None on the others."""
    s, S = _stages(group)
    x = None
    if s > 0:
        x = torch.empty((*tokens.shape, model.cfg.hidden_size),
                        dtype=model.dtype, device=tokens.device)
        stage_handoff(group, recv=x)
    x = model.stage_embed(tokens, lens, x=x)
    if s < S - 1:
        stage_handoff(group, send=x)
        return None
    return model.embed_pool(x, lens)

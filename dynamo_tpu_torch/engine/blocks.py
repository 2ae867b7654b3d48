"""The engine's device blocks: the bodies the JAX engine compiles, as
PyTorch functions of tensors that the graph runner captures on the card.

Each `make_*` returns ``block(inputs) -> outputs`` (dicts of tensors).  A
block reads its inputs, never writes them, and writes nothing in place
but the KV pool -- so a replayed graph and an uncaptured call on the same
inputs compute the same thing, and a block's outputs (the carries) can be
copied into the next block's inputs on the device with no host between.

- `make_decode_block`: `_make_decode_scan` + `_build_decode_step` of
  `dynamo_tpu/engine/engine.py`, the kernel-path branch (`body_common`,
  the per-step loop the JAX engine runs whenever attention is the Pallas
  kernel): K forward + sample steps; rows past `max_valid_pos` write
  through an all-trash table row; penalty counts update by scatter-add.
- `make_cc_block`: `_make_decode_scan_cc` + `_build_decode_step_cc`: the
  same with the device-resident loop's active mask, budgets, stop ids,
  chunk rows and the splice prologue.
- `make_spec_block`: `_build_spec_verify_step`: one `forward_verify` over
  k+1 positions, per-position sampling, the accepted draft prefix.

Inputs shared by the blocks: ``seeds`` [B] int64; the sampling columns
``temperature``, ``top_k``, ``top_p``, ``fp``, ``pp`` [B]; ``table``
[B, W] int32; for M-RoPE models ``rope_off`` [B] int64, each row's rope
delta (a static input like the others: the engine refreshes it before
every replay, and a spliced row brings its own).  Token ids, positions
and counters are int64.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from ..ops.sampling import (
    SamplingParams,
    apply_penalties,
    compute_logprobs,
    sample_tokens_block,
    sample_tokens_maybe_greedy,
    speculative_accept,
    top_logprobs,
)

# static top-k width for OpenAI `top_logprobs` responses (API max is 20)
TOPLP = 20

SAMP_COLUMNS = ("temperature", "top_k", "top_p", "fp", "pp")


@dataclass(frozen=True)
class Variant:
    """The compile-time flags of a step (one graph per combination)."""

    penalized: bool = False
    with_top: bool = False
    greedy: bool = False


def _bits(x: torch.Tensor) -> torch.Tensor:
    """int → its int32 bits as float32 (`lax.bitcast_convert_type`)."""
    return x.to(torch.int32).view(torch.float32)


def pack_out(out, logp, logits=None) -> torch.Tensor:
    """Sampled tokens + logprobs (+ top-TOPLP ids and logprobs when
    `logits` is given) in ONE float32 row per step, so a block comes back
    in one host copy.  Layout: [tok(B) | logp(B) | top_ids(B*TOPLP) |
    top_lps(B*TOPLP)] (`_pack_out`)."""
    parts = [_bits(out), logp.float()]
    if logits is not None:
        ids, lps = top_logprobs(logits, TOPLP)
        parts += [_bits(ids).reshape(-1), lps.reshape(-1)]
    return torch.cat(parts, dim=-1)


def unpack_out(packed: np.ndarray, b: int, with_top: bool = False):
    """Inverse of `pack_out`; returns (toks, logp, top_ids, top_lps)."""
    toks = np.ascontiguousarray(packed[..., :b]).view(np.int32)
    logp = packed[..., b:2 * b]
    if not with_top:
        return toks, logp, None, None
    ids = np.ascontiguousarray(packed[..., 2 * b:2 * b + b * TOPLP]).view(np.int32)
    lps = packed[..., 2 * b + b * TOPLP:]
    return (toks, logp, ids.reshape(*packed.shape[:-1], b, TOPLP),
            lps.reshape(*packed.shape[:-1], b, TOPLP))


def out_widths(with_top: bool) -> tuple:
    """The per-row widths of `pack_out`'s sections, in order."""
    return (1, 1, TOPLP, TOPLP) if with_top else (1, 1)


def join_packed(parts: List[torch.Tensor], widths) -> torch.Tensor:
    """Packed results of row blocks (each [..., sum(widths) * b], the
    same b; sections of `widths` values a row, row-major) as one packed
    result over all the blocks' rows, in block order: each section's
    blocks side by side (the counterpart of JAX's `_unpack_rows(...,
    blocks=R)`, which unpacks block-wise instead)."""
    if len(parts) == 1:
        return parts[0]
    b = parts[0].shape[-1] // sum(widths)
    out, off = [], 0
    for w in widths:
        out += [p[..., off * b:(off + w) * b] for p in parts]
        off += w
    return torch.cat(out, dim=-1)


def pack_out_cc(out, logp, act, logits=None) -> torch.Tensor:
    """`pack_out` plus the per-row EMITTED flag of the device-resident loop
    (1.0 where the row emitted at this step).  Layout: [tok(B) | logp(B) |
    act(B) | top_ids(B*TOPLP) | top_lps] (`_pack_out_cc`)."""
    parts = [_bits(out), logp.float(), act.float()]
    if logits is not None:
        ids, lps = top_logprobs(logits, TOPLP)
        parts += [_bits(ids).reshape(-1), lps.reshape(-1)]
    return torch.cat(parts, dim=-1)


def unpack_out_cc(packed: np.ndarray, b: int, with_top: bool = False):
    """Inverse of `pack_out_cc`; returns (toks, logp, flags, top_ids,
    top_lps) with `flags` a bool emitted-mask aligned with toks."""
    toks = np.ascontiguousarray(packed[..., :b]).view(np.int32)
    logp = packed[..., b:2 * b]
    flags = packed[..., 2 * b:3 * b] > 0.5
    if not with_top:
        return toks, logp, flags, None, None
    ids = np.ascontiguousarray(packed[..., 3 * b:3 * b + b * TOPLP]).view(np.int32)
    lps = packed[..., 3 * b + b * TOPLP:]
    return (toks, logp, flags, ids.reshape(*packed.shape[:-1], b, TOPLP),
            lps.reshape(*packed.shape[:-1], b, TOPLP))


def unpack_spec(packed: np.ndarray, b: int, s: int):
    """Inverse of the verify block's packing: (tokens [B, S] int32,
    logprobs [B, S] float32, accepted draft count [B] int32)."""
    n = b * s
    toks = np.ascontiguousarray(packed[:n]).view(np.int32).reshape(b, s)
    logp = packed[n:2 * n].reshape(b, s)
    n_acc = np.ascontiguousarray(packed[2 * n:2 * n + b]).view(np.int32)
    return toks, logp, n_acc


def ngram_draft(tokens: List[int], k: int, min_match: int,
                max_match: int = 4, history: int = 256) -> List[int]:
    """Prompt-lookup / n-gram draft (host side, no draft model): the k
    tokens that followed the MOST RECENT earlier occurrence of the
    sequence's trailing m-gram, the longest m in [min_match, max_match]
    first.  No match repeats the last token (`_ngram_draft`)."""
    hist = np.asarray(tokens[-history:], np.int64)
    n = len(hist)
    for m in range(min(max_match, n - 1), min_match - 1, -1):
        windows = np.lib.stride_tricks.sliding_window_view(hist, m)[:n - m]
        hits = np.nonzero((windows == hist[n - m:]).all(axis=1))[0]
        if hits.size:
            s = int(hits[-1])
            cont = hist[s + m:s + m + k].tolist()
            return (cont + [cont[-1]] * k)[:k]
    last = int(tokens[-1]) if tokens else 0
    return [last] * k


def samp_of(inp: Dict[str, torch.Tensor]) -> SamplingParams:
    return SamplingParams(*(inp[c] for c in SAMP_COLUMNS))


def sample_pack(logits, inp, ctr, v: Variant):
    """A prefill's sampling tail (eager): (tokens [B], packed [P])."""
    out = sample_tokens_maybe_greedy(logits, samp_of(inp), inp["seeds"], ctr,
                                     v.greedy)
    logp = compute_logprobs(logits, out)
    return out, pack_out(out, logp, logits if v.with_top else None)


def _masked_step(model, kv, tok, pos, ok, table, max_valid_pos,
                 rope_off=None):
    """One `forward_decode` where rows not `ok` write through an all-trash
    table row and out-of-window rows use position 0 (`body_common`);
    `rope_off` shifts the rope position only, never the KV slot."""
    safe = torch.where(pos < max_valid_pos, pos, torch.zeros_like(pos))
    tbl = torch.where(ok[:, None], table, torch.zeros_like(table))
    return model.forward_decode(kv, tok, safe, tbl, rope_off)


def make_decode_block(model, kv, n_steps: int, max_valid_pos: int,
                      v: Variant):
    """K decode steps.  Inputs: tok, pos, ctr [B], counts [B, V] (penalized
    only), table, seeds, sampling columns.  Outputs: packed [K, P] and the
    carries tok, pos, ctr (+ counts)."""

    def block(inp):
        samp = samp_of(inp)
        tok, pos, ctr = inp["tok"], inp["pos"], inp["ctr"]
        cts = inp["counts"] if v.penalized else None
        rows = []
        for _ in range(n_steps):
            logits = _masked_step(model, kv, tok, pos, pos < max_valid_pos,
                                  inp["table"], max_valid_pos,
                                  inp.get("rope_off"))
            if v.penalized:
                logits = apply_penalties(logits, cts, samp.frequency_penalty,
                                         samp.presence_penalty)
            out = sample_tokens_maybe_greedy(logits, samp, inp["seeds"], ctr,
                                             v.greedy)
            if v.penalized:
                cts = cts.scatter_add(1, out[:, None],
                                      torch.ones_like(cts[:, :1]))
            logp = compute_logprobs(logits, out)
            rows.append(pack_out(out, logp, logits if v.with_top else None))
            tok, pos, ctr = out, pos + 1, ctr + 1
        res = {"packed": torch.stack(rows), "tok": tok, "pos": pos, "ctr": ctr}
        if v.penalized:
            res["counts"] = cts
        return res

    return block


def make_cc_block(model, kv, n_steps: int, max_valid_pos: int, v: Variant):
    """K steps of the device-resident loop.  Inputs beyond the decode
    block's: act [B] bool (active at block start), budget [B] (tokens the
    row may still emit), stops [B, K] (-1 padded stop/eos ids), chunk_toks
    [B, T] (prompt tokens to feed), chunk_rem [B] (how many this block
    feeds), chunk_samples [B] bool (the last fed token completes the
    prompt), and the splice overlay reset [B] bool, init_pos, init_budget
    [B].  Outputs: packed [K, P] with the emitted flags, and the carries
    tok, pos, ctr, act, budget (+ counts).

    While a chunk row feeds it is active (KV written, position advancing)
    but emits nothing: its counter, counts and budget stay put, so its
    stream is the split prefill+decode's."""

    def block(inp):
        samp = samp_of(inp)
        reset = inp["reset"]
        pos = torch.where(reset, inp["init_pos"], inp["pos"])
        ctr = torch.where(reset, torch.zeros_like(inp["ctr"]), inp["ctr"])
        budget = torch.where(reset, inp["init_budget"], inp["budget"])
        cts = None
        if v.penalized:
            cts = torch.where(reset[:, None], torch.zeros_like(inp["counts"]),
                              inp["counts"])
        chunk_toks, chunk_rem = inp["chunk_toks"], inp["chunk_rem"]
        feeds = chunk_rem > 0
        act = inp["act"] | feeds
        tok = torch.where(feeds, chunk_toks[:, 0], inp["tok"])
        cidx = torch.zeros_like(chunk_rem)
        stops = inp["stops"]
        T = chunk_toks.shape[1]
        rows = []
        for _ in range(n_steps):
            logits = _masked_step(model, kv, tok, pos,
                                  (pos < max_valid_pos) & act, inp["table"],
                                  max_valid_pos, inp.get("rope_off"))
            if v.penalized:
                logits = apply_penalties(logits, cts, samp.frequency_penalty,
                                         samp.presence_penalty)
            out = sample_tokens_maybe_greedy(logits, samp, inp["seeds"], ctr,
                                             v.greedy)
            feeding = cidx < chunk_rem
            completing = feeding & (cidx + 1 == chunk_rem) & inp["chunk_samples"]
            emit = act & (~feeding | completing)
            emitf = emit.float()
            ctr = ctr + emit.long()
            if v.penalized:
                cts = cts.scatter_add(1, out[:, None], emitf[:, None])
            logp = compute_logprobs(logits, out)
            rows.append(pack_out_cc(out, logp, emitf,
                                    logits if v.with_top else None))
            hit = (out[:, None] == stops).any(dim=-1)
            budget = budget - emit.long()
            cidx_next = cidx + feeding.long()
            fed = torch.gather(chunk_toks, 1,
                               cidx_next.clamp(0, T - 1)[:, None])[:, 0]
            tok = torch.where(cidx_next < chunk_rem, fed, out)
            act_next = torch.where(emit, act & ~hit & (budget > 0),
                                   act & (cidx_next < chunk_rem))
            pos = pos + act.long()
            act, cidx = act_next, cidx_next
        res = {"packed": torch.stack(rows), "tok": tok, "pos": pos,
               "ctr": ctr, "act": act, "budget": budget}
        if v.penalized:
            res["counts"] = cts
        return res

    return block


def make_spec_block(model, kv, greedy: bool):
    """The draft-verify step: `forward_verify` scores the k+1 positions of
    tokens [B, k+1] (the last accepted token, then k drafts) written from
    pos [B]; every position samples from its own (seed, ctr + j) stream
    and the accepted draft prefix is counted.  Output: packed
    [tok(B*(k+1)) | logp(B*(k+1)) | n_accepted(B)]."""

    def block(inp):
        tokens = inp["tokens"]
        B, S = tokens.shape
        prefix = inp["pos"].to(torch.int32)
        chunk = torch.full_like(prefix, S)
        logits = model.forward_verify(kv, tokens, inp["table"], prefix, chunk,
                                      inp.get("rope_off"))
        out, logp = sample_tokens_block(logits, samp_of(inp), inp["seeds"],
                                        inp["ctr"], greedy)
        n_acc = speculative_accept(out, tokens)
        return {"packed": torch.cat([_bits(out).reshape(-1), logp.reshape(-1),
                                     _bits(n_acc)])}

    return block

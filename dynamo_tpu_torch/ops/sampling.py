"""Token sampling: greedy / temperature / top-k / top-p, vectorized over
the batch, following the JAX package's `ops/sampling.py` rules:

- greedy rows (temperature 0) take ``argmax``;
- unconstrained temperature rows sample by Gumbel-argmax over the vocab;
- top-k / top-p rows work on a top-``TOP_K_CAP`` slice; top-p mass is
  measured against the FULL softmax and conditioned on the slice.

Nothing here reads a tensor back to the host: seeds and counters are [B]
device tensors and greedy is a static flag, so the engine's decode blocks
capture the whole sampling tail into their CUDA graphs.

Each row draws from its own stream keyed by ``(seed, counter)``, exactly
as the JAX package does: ``fold_in(PRNGKey(seed), counter)``, ``split``
into a full-vocab key and a top-K key, and ``gumbel`` under each
(`threefry.py`, bit-equal to ``jax.random``).  So a row's sample does not
depend on what it is batched with, and a seeded request gives the JAX
worker's tokens.  The whole batch is keyed and drawn at once.
"""

from __future__ import annotations

from dataclasses import dataclass
import torch

from . import threefry

TOP_K_CAP = 64


@dataclass
class SamplingParams:
    """Per-row sampling state, shape [B] each."""

    temperature: torch.Tensor  # 0.0 → greedy
    top_k: torch.Tensor  # 0 → disabled
    top_p: torch.Tensor  # 1.0 → disabled
    frequency_penalty: torch.Tensor
    presence_penalty: torch.Tensor

    @staticmethod
    def make(temperature, top_k, top_p, frequency_penalty=None,
             presence_penalty=None, device="cpu") -> "SamplingParams":
        n = len(temperature)

        def f32(x):
            return torch.as_tensor(x, dtype=torch.float32, device=device)

        return SamplingParams(
            f32(temperature),
            torch.as_tensor(top_k, dtype=torch.int64, device=device),
            f32(top_p),
            f32(frequency_penalty if frequency_penalty is not None else [0.0] * n),
            f32(presence_penalty if presence_penalty is not None else [0.0] * n),
        )


def _rows(x, device) -> torch.Tensor:
    """[B] int64 on `device` from a tensor or a host sequence."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64)
    return torch.as_tensor([int(v) for v in x], dtype=torch.int64, device=device)


def gumbel_noise(seeds: torch.Tensor, counters: torch.Tensor, V: int,
                 K: int) -> tuple:
    """Per-row Gumbel noise for the full vocab [B, V] and the top-K slice
    [B, K] from each row's (seed, counter) key, as the JAX package's
    `_sample_nongreedy` draws it (seeds taken modulo 2**32).  `seeds` and
    `counters` are [B] tensors on the device the noise is drawn on; every
    row gets both draws (a row that does not read one discards it), so
    the draw has no data-dependent shape and can sit in a CUDA graph.
    Both draws are one hash."""
    sub = threefry.split(threefry.fold_in(threefry.prng_key(seeds), counters))
    return tuple(threefry.gumbel_parts([(sub[:, 0], V), (sub[:, 1], K)],
                                       seeds.device))


def sample_tokens(
    logits: torch.Tensor,  # [B, V]
    params: SamplingParams,
    seeds,  # [B] per-request seed (tensor, or a host sequence)
    counters,  # [B] tokens generated so far
) -> torch.Tensor:
    """One token per row ([B] int64). Greedy rows take argmax; the others
    draw from their own (seed, counter) stream.  No host branch: the
    sampled tail runs for every row and `torch.where` picks greedy rows,
    which gives the JAX function's tokens (its all-greedy `lax.cond`
    short-cut returns the same argmax)."""
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1)
    B, V = logits.shape
    K = min(TOP_K_CAP, V)
    g_full, g_sub = gumbel_noise(_rows(seeds, logits.device),
                                 _rows(counters, logits.device), V, K)
    return _sample_nongreedy(logits, greedy, params, g_full, g_sub)


def sample_tokens_maybe_greedy(logits, params, seeds, counters,
                               greedy: bool = False) -> torch.Tensor:
    """`sample_tokens`, or a STATICALLY greedy argmax when the caller knows
    every row is temperature 0 (the JAX function of the same name): the
    engine keeps a separate greedy variant of each step, so an all-greedy
    batch never draws noise."""
    if greedy:
        return torch.argmax(logits.float(), dim=-1)
    return sample_tokens(logits, params, seeds, counters)


def sample_tokens_block(logits: torch.Tensor, params: SamplingParams, seeds,
                        counters, greedy: bool = False):
    """One token per POSITION of a logits block [B, S, V]: position j of
    row b draws from the row's stream at counter ``counters[b] + j`` --
    the tokens S sequential decode steps would sample (the verify tail of
    self-speculative decoding).  Returns (tokens [B, S] int64, logprobs
    [B, S] float32)."""
    B, S, V = logits.shape
    flat = logits.reshape(B * S, V)
    if greedy:
        out = torch.argmax(flat.float(), dim=-1)
    else:
        def rep(t):  # [B] -> [B*S], row-major (a view expanded, no sync)
            return t[:, None].expand(B, S).reshape(-1)

        flat_params = SamplingParams(*(rep(t) for t in (
            params.temperature, params.top_k, params.top_p,
            params.frequency_penalty, params.presence_penalty)))
        dev = logits.device
        ctr = (_rows(counters, dev)[:, None]
               + torch.arange(S, device=dev)[None, :]).reshape(-1)
        out = sample_tokens(flat, flat_params, rep(_rows(seeds, dev)), ctr)
    logp = compute_logprobs(flat, out)
    return out.reshape(B, S), logp.reshape(B, S)


def speculative_accept(sampled: torch.Tensor, fed: torch.Tensor) -> torch.Tensor:
    """Length of the accepted draft prefix per row ([B] int64): draft j
    (``fed[:, j+1]``) is accepted iff every earlier draft matched and the
    model's own sample at its position (``sampled[:, j]``) equals it --
    for a deterministic drafter, exactly rejection sampling."""
    match = (sampled[:, :-1] == fed[:, 1:]).to(torch.int64)
    return torch.cumprod(match, dim=1).sum(dim=1)


def _sample_nongreedy(logits, greedy, params, g_full, g_sub):
    """The sampling rules of the JAX package's `_sample_nongreedy`, given
    each row's Gumbel noise for the full vocab and the top-K slice."""
    K = g_sub.shape[1]
    temp = torch.clamp(params.temperature, min=1e-6)[:, None]
    scaled = logits / temp
    full_sample = torch.argmax(scaled + g_full, dim=-1)

    vals, idx = torch.topk(scaled, K, dim=-1)  # sorted descending
    j = torch.arange(K, device=logits.device)[None, :]
    tk = params.top_k
    k_eff = torch.where(tk > 0, torch.clamp(tk, max=K), torch.full_like(tk, K))
    topk_keep = j < k_eff[:, None]
    lse = torch.logsumexp(scaled, dim=-1, keepdim=True)
    probs = torch.exp(vals - lse)
    cum = torch.cumsum(probs, dim=-1)
    topp_keep = (cum - probs) < params.top_p[:, None] * cum[:, -1:]
    keep = topk_keep & topp_keep
    keep[:, 0] = True
    masked = torch.where(keep, vals, torch.full_like(vals, float("-inf")))
    sub_pick = torch.argmax(masked + g_sub, dim=-1)
    sub_sample = torch.gather(idx, 1, sub_pick[:, None])[:, 0]

    truncated = (params.top_k > 0) | (params.top_p < 1.0)
    sampled = torch.where(truncated, sub_sample, full_sample)
    return torch.where(params.temperature <= 0.0, greedy, sampled)


def compute_logprobs(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Log-probability of `tokens` [B] under `logits` [B, V]."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(logp, 1, tokens.long()[:, None])[:, 0]


def apply_penalties(logits, counts, frequency_penalty, presence_penalty):
    """OpenAI frequency/presence penalties over generated tokens (vLLM
    semantics: `counts` [B, V] holds output-token occurrences only)."""
    logits = logits.float()
    return (logits
            - frequency_penalty[:, None] * counts
            - presence_penalty[:, None] * (counts > 0).float())


def top_logprobs(logits: torch.Tensor, k: int):
    """Top-k (ids, logprobs) per row for OpenAI `top_logprobs`."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    vals, idx = torch.topk(logp, k, dim=-1)
    return idx.to(torch.int32), vals

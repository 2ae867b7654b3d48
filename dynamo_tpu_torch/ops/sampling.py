"""Token sampling: greedy / temperature / top-k / top-p, vectorized over
the batch, following the JAX package's `ops/sampling.py` rules:

- greedy rows (temperature 0) take ``argmax``;
- unconstrained temperature rows sample by Gumbel-argmax over the vocab;
- top-k / top-p rows work on a top-``TOP_K_CAP`` slice; top-p mass is
  measured against the FULL softmax and conditioned on the slice.

Each row draws from its own stream keyed by ``(seed, counter)``, exactly
as the JAX package does: ``fold_in(PRNGKey(seed), counter)``, ``split``
into a full-vocab key and a top-K key, and ``gumbel`` under each
(`threefry.py`, bit-equal to ``jax.random``).  So a row's sample does not
depend on what it is batched with, and a seeded request gives the JAX
worker's tokens.  The whole batch is keyed and drawn at once.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

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


def gumbel_noise(seeds: Sequence[int], counters: Sequence[int], V: int, K: int,
                 device, full_rows: Sequence[int]) -> tuple:
    """Per-row Gumbel noise for the full vocab [B, V] and the top-K slice
    [B, K] from each row's (seed, counter) key, as the JAX package's
    `_sample_nongreedy` draws it (seeds taken modulo 2**32).  Only
    `full_rows` get full-vocab noise (the others' stays 0): the full draw
    is the costly one, and only unconstrained rows read it.  The keys are
    [B, 2] words derived on the host; both draws are one hash on
    `device`."""
    seeds = torch.tensor([int(s) & threefry.MASK for s in seeds], dtype=torch.int64)
    counters = torch.tensor([int(c) & threefry.MASK for c in counters],
                            dtype=torch.int64)
    sub = threefry.split(threefry.fold_in(threefry.prng_key(seeds), counters))
    full_rows = list(full_rows)
    g_full = torch.zeros((len(seeds), V), dtype=torch.float32, device=device)
    if not full_rows:
        return g_full, threefry.gumbel_parts([(sub[:, 1], K)], device)[0]
    g_sub, drawn = threefry.gumbel_parts([(sub[:, 1], K), (sub[full_rows, 0], V)], device)
    g_full[torch.tensor(full_rows, dtype=torch.int64).to(device)] = drawn
    return g_full, g_sub


def sample_tokens(
    logits: torch.Tensor,  # [B, V]
    params: SamplingParams,
    seeds: Sequence[int],  # [B] per-request seed
    counters: Sequence[int],  # [B] tokens generated so far
) -> torch.Tensor:
    """One token per row ([B] int64). Greedy rows take argmax."""
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1)
    temp = params.temperature.tolist()
    if all(t <= 0.0 for t in temp):
        return greedy
    B, V = logits.shape
    K = min(TOP_K_CAP, V)
    top_k, top_p = params.top_k.tolist(), params.top_p.tolist()
    full_rows = [i for i in range(B)
                 if temp[i] > 0.0 and top_k[i] <= 0 and top_p[i] >= 1.0]
    g_full, g_sub = gumbel_noise(seeds, counters, V, K, logits.device, full_rows)
    return _sample_nongreedy(logits, greedy, params, g_full, g_sub)


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

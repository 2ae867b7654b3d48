"""The port's sampling (dynamo_tpu_torch.ops.sampling) against the JAX
package's.

Greedy, logprobs, penalties and top logprobs match JAX to 1e-5.  Seeded
rows use torch generators keyed by (seed, counter), not JAX's threefry, so
sampled rows are compared by their support (the top-k/top-p keep set),
their distribution, and their reproducibility across batch compositions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.ops import sampling as js
from dynamo_tpu_torch.ops import sampling as ts


def _logits(B=4, V=96, seed=0, scale=3.0):
    return (np.random.default_rng(seed).standard_normal((B, V)) * scale).astype(np.float32)


def _params(mod, temp, top_k, top_p, fp=None, pp=None):
    return mod.SamplingParams.make(temp, top_k, top_p, fp, pp)


def test_greedy_matches_jax():
    lg = _logits()
    B = lg.shape[0]
    want = js.sample_tokens(jnp.asarray(lg), _params(js, [0.0] * B, [0] * B, [1.0] * B),
                            jnp.zeros(B, jnp.uint32), jnp.zeros(B, jnp.int32))
    got = ts.sample_tokens(torch.from_numpy(lg),
                           _params(ts, [0.0] * B, [0] * B, [1.0] * B),
                           [0] * B, [0] * B)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_logprobs_penalties_top_logprobs_match_jax():
    lg = _logits(seed=1)
    B, V = lg.shape
    rng = np.random.default_rng(2)
    counts = rng.integers(0, 3, (B, V)).astype(np.float32)
    fp = np.array([0.0, 0.5, 1.0, 0.2], np.float32)
    pp = np.array([0.3, 0.0, 0.7, 0.1], np.float32)
    want = js.apply_penalties(jnp.asarray(lg), jnp.asarray(counts),
                              jnp.asarray(fp), jnp.asarray(pp))
    got = ts.apply_penalties(torch.from_numpy(lg), torch.from_numpy(counts),
                             torch.from_numpy(fp), torch.from_numpy(pp))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    toks = rng.integers(0, V, B).astype(np.int32)
    np.testing.assert_allclose(
        ts.compute_logprobs(torch.from_numpy(lg), torch.from_numpy(toks)).numpy(),
        np.asarray(js.compute_logprobs(jnp.asarray(lg), jnp.asarray(toks))),
        atol=1e-5)
    ids_t, lps_t = ts.top_logprobs(torch.from_numpy(lg), 5)
    ids_j, lps_j = js.top_logprobs(jnp.asarray(lg), 5)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    np.testing.assert_allclose(lps_t.numpy(), np.asarray(lps_j), atol=1e-5)


def _support(mod, lg_row, temp, top_k, top_p, n=300):
    """Tokens the sampler picks for one row over n (seed, counter) draws."""
    lg = np.repeat(lg_row[None], n, 0)
    p = _params(mod, [temp] * n, [top_k] * n, [top_p] * n)
    if mod is js:
        out = js.sample_tokens(jnp.asarray(lg), p, jnp.arange(n, dtype=jnp.uint32),
                               jnp.zeros(n, jnp.int32))
        return np.asarray(out)
    return ts.sample_tokens(torch.from_numpy(lg), p, list(range(n)), [0] * n).numpy()


@pytest.mark.parametrize("top_k,top_p", [(3, 1.0), (0, 0.6), (5, 0.8), (1, 1.0)])
def test_top_k_top_p_keep_sets_agree(top_k, top_p):
    """Both samplers draw from the same keep set: the supports seen over
    many seeded draws coincide (probabilities inside the set are >= 5%,
    so 300 draws see every member)."""
    lg = np.array([4.0, 3.6, 3.3, 3.0, 2.7, 2.2, 0.0, -1.0] + [-4.0] * 24,
                  np.float32)
    sj = set(_support(js, lg, 1.0, top_k, top_p).tolist())
    st = set(_support(ts, lg, 1.0, top_k, top_p).tolist())
    assert st == sj
    if top_k:
        assert len(st) <= top_k


def test_unconstrained_distribution_matches_softmax():
    lg = np.array([1.0, 0.5, 0.0, -0.5, -1.0, 2.0], np.float32)
    n = 4000
    picks = _support(ts, lg, 0.7, 0, 1.0, n=n)
    freq = np.bincount(picks, minlength=len(lg)) / n
    p = np.exp(lg / 0.7) / np.exp(lg / 0.7).sum()
    np.testing.assert_allclose(freq, p, atol=0.03)


def test_seeded_rows_reproducible_across_batches():
    """A row's sample depends on its (seed, counter) only, not on what it
    is batched with or where it sits in the batch."""
    lg = _logits(B=6, V=200, seed=3, scale=1.0)
    row = lg[2]
    p1 = _params(ts, [0.9], [0], [1.0])
    alone = ts.sample_tokens(torch.from_numpy(row[None]), p1, [11], [5])
    p6 = _params(ts, [0.0, 1.2, 0.9, 0.5, 0.9, 0.9], [0, 5, 0, 0, 0, 40],
                 [1.0, 0.9, 1.0, 1.0, 1.0, 0.5])
    mixed = ts.sample_tokens(torch.from_numpy(np.stack([lg[0], lg[1], row, lg[3], row, lg[5]])),
                             p6, [1, 2, 11, 4, 11, 6], [0, 1, 5, 3, 5, 9])
    assert int(mixed[2]) == int(alone[0]) == int(mixed[4])
    # counters advance the stream: a long run of steps is not constant
    steps = [int(ts.sample_tokens(torch.from_numpy(row[None]), p1, [11], [c])[0])
             for c in range(20)]
    assert len(set(steps)) > 1

"""The port's sampling (dynamo_tpu_torch.ops.sampling) against the JAX
package's.

Greedy, logprobs, penalties and top logprobs match JAX to 1e-5.  The
port's threefry (dynamo_tpu_torch.ops.threefry) is bit-equal to
``jax.random`` for keys and bits; its Gumbel draws agree to 1e-5 absolute
(a few float32 ulps of the largest draws: the two frameworks' ``log``
round differently).  Seeded sampling is token-identical to JAX's; sampled
rows are also checked by their support (the top-k/top-p keep set), their
distribution, and their reproducibility across batch compositions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.ops import sampling as js
from dynamo_tpu_torch.ops import sampling as ts
from dynamo_tpu_torch.ops import threefry as tf


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


_SEEDS = (0, 7, 2**31 - 1)
_COUNTERS = (0, 1, 37)
_NS = (1, 96, 1001)


def _jax_key(seed, counter):
    return jax.random.fold_in(jax.random.PRNGKey(np.uint32(seed)),
                              np.int32(counter))


def _torch_key(seed, counter):
    return tf.fold_in(tf.prng_key(torch.tensor([seed])), torch.tensor([counter]))


def test_threefry2x32_hash_bit_equal():
    from jax._src import prng as jprng

    rng = np.random.default_rng(6)
    key = rng.integers(0, 2**32, 2, dtype=np.uint64).astype(np.uint32)
    count = rng.integers(0, 2**32, 64, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jprng.threefry_2x32(jnp.asarray(key), jnp.asarray(count)))
    k = torch.from_numpy(key.astype(np.int64))
    c = torch.from_numpy(count.astype(np.int64))
    y1, y2 = tf.threefry2x32(k[0], k[1], c[:32], c[32:])
    np.testing.assert_array_equal(torch.cat([y1, y2]).numpy(),
                                  want.astype(np.int64))


@pytest.mark.parametrize("seed", _SEEDS)
@pytest.mark.parametrize("counter", _COUNTERS)
def test_threefry_keys_and_bits_bit_equal(seed, counter):
    jk, tk = _jax_key(seed, counter), _torch_key(seed, counter)
    np.testing.assert_array_equal(tk[0].numpy(), np.asarray(jk).astype(np.int64))
    np.testing.assert_array_equal(tf.split(tk)[0].numpy(),
                                  np.asarray(jax.random.split(jk)).astype(np.int64))
    tiny = float(np.finfo(np.float32).tiny)
    for n in _NS:
        np.testing.assert_array_equal(
            tf.random_bits32(tk, n)[0].numpy(),
            np.asarray(jax.random.bits(jk, (n,), jnp.uint32)).astype(np.int64))
        np.testing.assert_array_equal(
            tf.uniform(tk, n, tiny, 1.0)[0].numpy(),
            np.asarray(jax.random.uniform(jk, (n,), jnp.float32, tiny, 1.0)))
        np.testing.assert_allclose(
            tf.gumbel(tk, n)[0].numpy(),
            np.asarray(jax.random.gumbel(jk, (n,), jnp.float32)), rtol=0, atol=1e-5)


def test_threefry_batch_equals_rows():
    """Keying a batch at once gives each row's own keys and draws."""
    seeds, ctrs = [3, 2**31 - 1, 0, 3], [5, 0, 9, 6]
    keys = tf.fold_in(tf.prng_key(torch.tensor(seeds)), torch.tensor(ctrs))
    rows = torch.cat([_torch_key(s, c) for s, c in zip(seeds, ctrs)])
    assert torch.equal(keys, rows)
    assert torch.equal(tf.random_bits32(keys, 50),
                       torch.cat([tf.random_bits32(rows[i:i + 1], 50)
                                  for i in range(4)]))


_MODES = {  # (temperature, top_k, top_p) per row
    "unconstrained": ([0.9, 0.7, 1.3, 0.5], [0] * 4, [1.0] * 4),
    "top_k": ([0.9, 1.0, 1.2, 0.8], [5, 1, 40, 64], [1.0] * 4),
    "top_p": ([0.9, 1.0, 1.2, 0.8], [0] * 4, [0.9, 0.5, 0.99, 0.2]),
    "mixed_with_greedy": ([0.0, 0.9, 0.0, 1.1], [0, 8, 0, 0], [1.0, 0.8, 1.0, 1.0]),
}


@pytest.mark.parametrize("mode", list(_MODES))
def test_seeded_sample_tokens_token_identical_to_jax(mode):
    temp, top_k, top_p = _MODES[mode]
    B, V = 4, 1000
    seeds = [0, 7, 2**31 - 1, 123456]
    for step, counter in enumerate((0, 1, 37)):
        lg = _logits(B=B, V=V, seed=10 + step, scale=2.0)
        want = js.sample_tokens(jnp.asarray(lg), _params(js, temp, top_k, top_p),
                                jnp.asarray(seeds, jnp.uint32),
                                jnp.full(B, counter, jnp.int32))
        got = ts.sample_tokens(torch.from_numpy(lg), _params(ts, temp, top_k, top_p),
                               seeds, [counter] * B)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gumbel_parts_equal_separate_draws():
    """One hash over several parts gives each part's own draws."""
    keys = tf.split(tf.fold_in(tf.prng_key(torch.tensor([5, 9, 2**31 - 1])),
                               torch.tensor([0, 3, 37])))
    got = tf.gumbel_parts([(keys[:, 1], 64), (keys[[0, 2], 0], 1001)], "cpu")
    assert torch.equal(got[0], tf.gumbel(keys[:, 1], 64))
    assert torch.equal(got[1], tf.gumbel(keys[[0, 2], 0], 1001))

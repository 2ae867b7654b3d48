"""Self-speculative decoding of the port against the JAX package, on the
CPU: the n-gram drafter, the verify forward (`Llama.forward_verify`, the
prefill kernel at S = k + 1 with logits at every position), the verify
tail's sampling and acceptance, and `TorchEngine(speculative_ngram_k=4)`
token-identical to JaxEngine's and to plain decode.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.engine import _ngram_draft
from dynamo_tpu.models import KVCache as JaxKVCache
from dynamo_tpu.models import forward_verify as jax_forward_verify
from dynamo_tpu.models import init_params as jax_init_params
from dynamo_tpu.models import tiny_config as jax_tiny_config
from dynamo_tpu.ops import sampling as js
from dynamo_tpu_torch.engine.blocks import ngram_draft
from dynamo_tpu_torch.models import KVCache, params_from_jax, tiny_config
from dynamo_tpu_torch.ops import sampling as ts

from test_torch_device_loop import both, collect, jax_engine, req, torch_engine


@pytest.fixture(scope="module")
def jax_params():
    return jax_init_params(jax_tiny_config(), jax.random.PRNGKey(0),
                           dtype=jnp.float32)


@pytest.mark.parametrize("tokens,k,min_match", [
    ([1, 2, 7, 8, 1, 2, 9, 1, 2], 3, 1),
    ([5, 1, 2, 6, 0, 5, 1, 2], 1, 1),
    ([4, 4, 7, 4, 4], 4, 2),
    ([10, 20, 30], 2, 2),
    ([3], 2, 1),
    ([], 2, 1),
    ([5, 6, 5, 6, 5, 6, 5, 6, 5], 4, 1),
])
def test_ngram_draft_equals_jax(tokens, k, min_match):
    assert ngram_draft(tokens, k, min_match) == _ngram_draft(tokens, k, min_match)


@pytest.mark.parametrize("greedy", [True, False])
def test_sample_tokens_block_bit_equal(greedy):
    """Position j of row b draws at counter c_b + j: the tokens of S
    sequential steps, bit-equal to JAX's; logprobs within 1e-5."""
    rng = np.random.default_rng(11)
    B, S, V = 3, 5, 200
    lg = (rng.standard_normal((B, S, V)) * 2).astype(np.float32)
    temp = [0.0, 0.0, 0.0] if greedy else [0.0, 0.8, 1.2]
    top_k, top_p = [0, 0, 10], [1.0, 0.9, 1.0]
    seeds, ctr = [3, 42, 2**31 - 1], [0, 4, 19]
    want = js.sample_tokens_block(
        jnp.asarray(lg), js.SamplingParams.make(temp, top_k, top_p),
        jnp.asarray(seeds, jnp.uint32), jnp.asarray(ctr, jnp.int32), greedy)
    got = ts.sample_tokens_block(
        torch.from_numpy(lg), ts.SamplingParams.make(temp, top_k, top_p),
        torch.tensor(seeds), torch.tensor(ctr), greedy)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-5)


def test_speculative_accept_bit_equal():
    rng = np.random.default_rng(2)
    sampled = rng.integers(0, 3, (16, 5)).astype(np.int32)
    fed = rng.integers(0, 3, (16, 5)).astype(np.int32)
    fed[:4, 1:] = sampled[:4, :-1]  # fully accepted rows
    want = np.asarray(js.speculative_accept(jnp.asarray(sampled),
                                            jnp.asarray(fed)))
    got = ts.speculative_accept(torch.from_numpy(sampled).long(),
                                torch.from_numpy(fed).long()).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[:4].tolist() == [4] * 4


def test_forward_verify_equals_jax(jax_params):
    """Logits at every position of a k+1 chunk written after a cached
    prefix, and the pool it leaves, within 1e-5 of the JAX function."""
    cfg = tiny_config()
    model = params_from_jax(cfg, jax.tree.map(np.asarray, jax_params),
                            device="cpu")
    rng = np.random.default_rng(4)
    page, P, B, S = 8, 16, 2, 5
    shape = (cfg.num_hidden_layers, P, page, cfg.num_key_value_heads,
             cfg.head_dim_)
    k0 = rng.standard_normal(shape).astype(np.float32)
    v0 = rng.standard_normal(shape).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    table = np.array([[1, 2, 3, 0], [4, 5, 0, 0]], np.int32)
    prefix = np.array([13, 6], np.int32)
    chunk = np.full((B,), S, np.int32)
    want, jkv = jax_forward_verify(
        jax_params, jax_tiny_config(), JaxKVCache(jnp.asarray(k0), jnp.asarray(v0)),
        jnp.asarray(tokens), jnp.asarray(table), jnp.asarray(prefix),
        jnp.asarray(chunk))
    kv = KVCache(torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy()))
    got = model.forward_verify(kv, torch.from_numpy(tokens).long(),
                               torch.from_numpy(table), torch.from_numpy(prefix),
                               torch.from_numpy(chunk))
    assert tuple(got.shape) == (B, S, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(kv.k.numpy(), np.asarray(jkv.k), atol=1e-5)
    np.testing.assert_allclose(kv.v.numpy(), np.asarray(jkv.v), atol=1e-5)


async def test_spec_decode_matches_jax_and_plain(jax_params):
    """k = 4 drafts: greedy rows (one with repeated n-grams, where drafts
    are accepted) and a seeded row equal JaxEngine's speculative streams
    and the port's plain decode; a stop inside an accepted run ends the
    stream there."""
    rs = [req([1, 2, 3, 4, 5], max_tokens=13), req([9, 8, 7], max_tokens=13),
          req([5, 6, 5, 6, 5, 6, 5, 6], max_tokens=13),
          req([1, 2, 3], max_tokens=10, temperature=0.9, seed=42)]
    got, want, trace, m = await both(jax_params, rs, speculative_ngram_k=4)
    assert got == want
    assert any(e["kind"] == "spec" for e in trace)
    assert m.spec_dispatches_total == sum(e["kind"] == "spec" for e in trace) > 0
    plain = torch_engine(jax_params)
    ref = [await collect(plain, r) for r in rs]
    await plain.shutdown()
    assert got == ref
    spec = torch_engine(jax_params, speculative_ngram_k=4)
    r = req([1, 2, 3, 4, 5], max_tokens=13)
    r["stop_conditions"]["stop_token_ids"] = [ref[0][0][2]]
    toks, reason, _ = await collect(spec, r)
    await spec.shutdown()  # joins the step thread: deferred frees applied
    released = spec.pool.free_pages + spec.pool.evictable_pages
    assert (toks, reason) == (ref[0][0][:3], "stop")
    assert released == spec.pool.num_pages - 1


async def test_spec_acceptance_on_a_constant_model(jax_params):
    """A zeroed model's greedy output is constant, so the drafts are
    accepted: more than 1.5 tokens per verify dispatch, with the
    acceptance telemetry in metrics(), as JaxEngine reports it."""
    zero = jax.tree.map(jnp.zeros_like, jax_params)
    r = req([7, 9, 11, 13], max_tokens=40)
    eng = torch_engine(zero, speculative_ngram_k=4)
    toks, reason, _ = await collect(eng, r)
    m = eng.metrics()
    await eng.shutdown()
    jeng = jax_engine(zero, speculative_ngram_k=4)
    jtoks, _, _ = await collect(jeng, r)
    jm = jeng.metrics()
    await jeng.shutdown()
    assert (len(toks), reason) == (40, "length") and toks == jtoks
    d = m.spec_dispatches_total
    assert (m.spec_accepted_tokens_total + d) / d > 1.5
    assert m.spec_draft_tokens_total == 4 * d
    assert (m.spec_draft_tokens_total, m.spec_accepted_tokens_total,
            m.spec_acceptance_rate) == (jm.spec_draft_tokens_total,
                                        jm.spec_accepted_tokens_total,
                                        jm.spec_acceptance_rate)

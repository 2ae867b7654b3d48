"""The port's dense Llama (dynamo_tpu_torch.models.llama) against the JAX
package's `models/llama.py` on the same weights (moved across with
`params_from_jax`).

f32 tiny config: prefill logits over two chunks (prefix 0, then a cached
prefix) match to 1e-5, eight greedy per-step decode tokens are identical
to JAX `forward_decode`, and the KV pool matches to 1e-5 outside trash
page 0.  bf16: logits `allclose` at 5e-2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models import config as jcfg
from dynamo_tpu.models import llama as jl
from dynamo_tpu_torch.models import config as tcfg
from dynamo_tpu_torch.models import llama as tl

PAGE, MAXP = 8, 8


def _tree(params):
    return jax.tree.map(np.asarray, params)


def _setup(jdtype):
    cfg_j = jcfg.tiny_config()
    params = jl.init_params(cfg_j, jax.random.PRNGKey(0), dtype=jdtype)
    cfg_t = tcfg.tiny_config()
    model = tl.params_from_jax(cfg_t, _tree(params), device="cpu")
    return cfg_j, params, cfg_t, model


def _table(B):
    return np.arange(1, 1 + B * MAXP, dtype=np.int32).reshape(B, MAXP)


def _run_both(jdtype, tdtype, n_decode=8):
    cfg_j, params, cfg_t, model = _setup(jdtype)
    rng = np.random.default_rng(0)
    B, S1, S2 = 2, 16, 8
    toks = rng.integers(0, cfg_j.vocab_size, (B, S1 + S2)).astype(np.int32)
    table = _table(B)
    P = 1 + B * MAXP
    kv_j = jl.KVCache.create(cfg_j, P, PAGE, jdtype)
    kv_t = tl.KVCache.create(cfg_t, P, PAGE, tdtype, "cpu")
    chunks = [  # (token slice, prefix_lens, chunk_lens)
        (slice(0, S1), [0, 0], [S1, 9]),
        (slice(S1, S1 + S2), [S1, 9], [S2, 5]),
    ]
    logits_j, logits_t = [], []
    for sl, pre, cl in chunks:
        t = toks[:, sl].copy()
        if pre[1] != S1:  # row 1 continues where its shorter first chunk ended
            t[1] = toks[1, pre[1]:pre[1] + t.shape[1]]
        lj, kv_j = jl.forward_prefill(params, cfg_j, kv_j, jnp.asarray(t),
                                      jnp.asarray(table), jnp.asarray(pre, jnp.int32),
                                      jnp.asarray(cl, jnp.int32))
        lt = model.forward_prefill(kv_t, torch.from_numpy(t).long(),
                                   torch.from_numpy(table),
                                   torch.tensor(pre, dtype=torch.int32),
                                   torch.tensor(cl, dtype=torch.int32))
        logits_j.append(np.asarray(lj, np.float32))
        logits_t.append(lt.numpy())
    if not n_decode:
        return logits_j, logits_t, None, None, kv_j, kv_t
    pos = np.array([S1 + S2, 9 + 5], np.int32)
    tok_j = jnp.argmax(jnp.asarray(logits_j[-1]), -1).astype(jnp.int32)
    toks_j = []
    for t in range(n_decode):
        lj, kv_j = jl.forward_decode(params, cfg_j, kv_j, tok_j,
                                     jnp.asarray(pos + t), jnp.asarray(table))
        tok_j = jnp.argmax(lj, -1).astype(jnp.int32)
        toks_j.append(np.asarray(tok_j))
    tok_t = torch.from_numpy(np.argmax(logits_t[-1], -1))
    toks_t = []
    for t in range(n_decode):
        lt = model.forward_decode(kv_t, tok_t, torch.from_numpy(pos + t).long(),
                                  torch.from_numpy(table))
        tok_t = lt.argmax(-1)
        toks_t.append(tok_t.numpy())
    return logits_j, logits_t, np.stack(toks_j), np.stack(toks_t), kv_j, kv_t


def test_f32_prefill_decode_and_pool_match_jax():
    logits_j, logits_t, toks_j, toks_t, kv_j, kv_t = _run_both(
        jnp.float32, torch.float32)
    for lj, lt in zip(logits_j, logits_t):
        np.testing.assert_allclose(lt, lj, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(toks_t, toks_j)
    np.testing.assert_allclose(kv_t.k.numpy()[:, 1:], np.asarray(kv_j.k)[:, 1:], atol=1e-5)
    np.testing.assert_allclose(kv_t.v.numpy()[:, 1:], np.asarray(kv_j.v)[:, 1:], atol=1e-5)


def test_bf16_prefill_logits_allclose():
    logits_j, logits_t, *_ = _run_both(jnp.bfloat16, torch.bfloat16, n_decode=0)
    for lj, lt in zip(logits_j, logits_t):
        np.testing.assert_allclose(lt, lj, atol=5e-2, rtol=5e-2)


def test_init_params_seeded_and_untied_head():
    cfg = tcfg.tiny_config(tie_word_embeddings=False)
    a = tl.init_params(cfg, torch.Generator().manual_seed(3), torch.float32, "cpu")
    b = tl.init_params(cfg, torch.Generator().manual_seed(3), torch.float32, "cpu")
    for (na, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), na
    assert a.lm_head is not None and a.lm_head.shape == (cfg.hidden_size, cfg.vocab_size)
    tied = tl.init_params(dataclasses.replace(cfg, tie_word_embeddings=True),
                          torch.Generator().manual_seed(3), torch.float32, "cpu")
    assert tied.lm_head is None
    x = torch.randn(2, cfg.hidden_size)
    assert tied.lm_logits(x).shape == (2, cfg.vocab_size)


@pytest.mark.parametrize("over", [{"mrope_section": (4, 2, 1)},
                                  {"num_experts": 4, "moe_impl": "megablocks"},
                                  {"kv_partition": True}])
def test_unported_model_features_refused(over):
    """What the port refuses: an M-RoPE section that does not split the
    rotary frequencies (M-RoPE itself is served since the vision slice,
    tests/test_torch_vision*.py), an unknown MoE dispatch (as JAX `_moe`
    does) and a partitioned KV pool on a flat engine (JAX's refusal
    without a mesh; a dp group serves one).  MoE,
    windows, sinks and biases are served since the model-breadth slice
    (tests/test_torch_gpt_oss.py)."""
    from dynamo_tpu_torch.engine import EngineConfig, TorchEngine

    if "kv_partition" in over:
        cfg = tcfg.tiny_config()
        model = tl.init_params(cfg, torch.Generator().manual_seed(0),
                               torch.float32, "cpu")
        with pytest.raises(ValueError, match="requires a serving mesh"):
            TorchEngine(cfg, model, EngineConfig(**over), device="cpu")
        return
    with pytest.raises(ValueError):
        tl.Llama(tcfg.tiny_config(**over), torch.float32, "cpu")

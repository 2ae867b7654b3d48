"""The port's int8 weights (dynamo_tpu_torch.models.quantization) against
the JAX package's `models/quantization.py` on the same numpy inputs, on
the CPU:

- `quantize_tensor` (plain and layer-stacked, f32 and bf16 inputs) and
  `quantize_params` bit-equal: the same int8 values and f32 scales, the
  tied model's added int8 head, MoE expert stacks left high-precision;
- `dequantize_tensor` equal and `matmul_any` within 1e-5;
- a JAX tree after `quantize_params` moves across with `params_from_jax`
  and gives JAX's prefill logits within 1e-5 (f32);
- `TorchEngine(quantization="int8")` quantizes its model at construction
  and gives `JaxEngine`'s int8 greedy tokens on a tiny dense config, with
  one-step and four-step decode blocks;
- `random_int8_params` builds the layout `quantize_params` produces.
"""

import asyncio

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxEngine
from dynamo_tpu.models import config as jcfg
from dynamo_tpu.models import llama as jl
from dynamo_tpu.models import quantization as jq
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.models import config as tcfg
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models import quantization as tq


def _np(x):
    return np.asarray(x)


def _torch(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_tensor_bit_equal(stacked, dtype):
    rng = np.random.default_rng(0)
    shape = (3, 48, 40) if stacked else (48, 40)
    w = (rng.normal(size=shape) * rng.uniform(0.01, 3, size=shape[-1])).astype(np.float32)
    w[..., 5] = 0.0  # an all-zero channel takes the 1e-8 floor
    if dtype == "bfloat16":
        w = w.astype(ml_dtypes.bfloat16)
    want = jq.quantize_tensor(jnp.asarray(w), stacked=stacked)
    got = tq.quantize_tensor(_torch(w), stacked=stacked)
    assert got["q"].dtype == torch.int8 and got["s"].dtype == torch.float32
    np.testing.assert_array_equal(got["q"].numpy(), _np(want["q"]))
    np.testing.assert_array_equal(got["s"].numpy(), _np(want["s"]))
    np.testing.assert_array_equal(
        tq.dequantize_tensor(got, torch.float32).numpy(),
        _np(jq.dequantize_tensor(want, jnp.float32)))


def test_matmul_any_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 48)).astype(np.float32)
    w = rng.normal(size=(48, 40)).astype(np.float32)
    wq_j = jq.quantize_tensor(jnp.asarray(w))
    wq_t = tq.quantize_tensor(torch.from_numpy(w))
    for a, b in ((wq_j, wq_t), (jnp.asarray(w), torch.from_numpy(w))):
        want = jq.matmul_any(jnp.asarray(x), a, "bsh,hd->bsd")
        got = tq.matmul_any(torch.from_numpy(x), b)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5, rtol=1e-5)


def _jax_and_port(cfg_kw, quantized=True):
    cfg_j, cfg_t = jcfg.ModelConfig(**cfg_kw), tcfg.ModelConfig(**cfg_kw)
    params = jl.init_params(cfg_j, jax.random.PRNGKey(0), dtype=jnp.float32)
    tree = jq.quantize_params(params) if quantized else params
    return cfg_j, params, tree, cfg_t


TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=512)


@pytest.mark.parametrize("case", ["untied", "tied", "moe"])
def test_quantize_params_bit_equal(case):
    """The port's in-place `quantize_params` on the model moved from an
    unquantized tree gives the JAX tree's int8 leaves; a tied model gains
    the head copy of embed.T; expert stacks and the router stay f32."""
    kw = dict(TINY, tie_word_embeddings=case == "tied")
    if case == "moe":
        kw.update(num_experts=4, num_experts_per_tok=2)
    cfg_j, params, want, cfg_t = _jax_and_port(kw)
    model = tl.params_from_jax(cfg_t, jax.tree.map(np.asarray, params),
                               device="cpu")
    assert tq.quantize_params(model) is model
    for key, leaf in want["layers"].items():
        for i, layer in enumerate(model.layers):
            got = getattr(layer, key)
            if jq.is_quantized(leaf):
                assert tq.is_quantized(got), key
                np.testing.assert_array_equal(got["q"].numpy(), _np(leaf["q"][i]))
                np.testing.assert_array_equal(got["s"].numpy(), _np(leaf["s"][i]))
            else:
                assert not tq.is_quantized(got), key
                np.testing.assert_array_equal(got.numpy(), _np(leaf[i]))
    assert tq.is_quantized(model.lm_head)
    np.testing.assert_array_equal(model.lm_head["q"].numpy(), _np(want["lm_head"]["q"]))
    np.testing.assert_array_equal(model.lm_head["s"].numpy(), _np(want["lm_head"]["s"]))
    if case == "moe":
        assert model.layers[0].w_gate.dim() == 3  # [E, h, f], not quantized


@pytest.mark.parametrize("tied", [False, True])
def test_quantized_tree_moves_across_and_matches_jax_logits(tied):
    cfg_j, _, tree, cfg_t = _jax_and_port(dict(TINY, tie_word_embeddings=tied))
    model = tl.params_from_jax(cfg_t, jax.tree.map(np.asarray, tree), device="cpu")
    assert all(tq.is_quantized(getattr(model.layers[0], k)) for k in tq.QUANT_KEYS)
    toks = np.random.default_rng(2).integers(0, 256, (2, 12)).astype(np.int32)
    kv_j = jl.KVCache.create(cfg_j, 5, 8, jnp.float32)
    kv_t = tl.KVCache.create(cfg_t, 5, 8, torch.float32, "cpu")
    table = np.array([[1, 2], [3, 4]], np.int32)
    lens = np.array([12, 7], np.int32)
    want, _ = jl.forward_prefill(tree, cfg_j, kv_j, jnp.asarray(toks),
                                 jnp.asarray(table), jnp.zeros(2, jnp.int32),
                                 jnp.asarray(lens))
    got = model.forward_prefill(kv_t, torch.from_numpy(toks).long(),
                                torch.from_numpy(table),
                                torch.zeros(2, dtype=torch.int32),
                                torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5, rtol=1e-5)


ECFG = dict(page_size=8, num_pages=64, max_num_seqs=4, max_prefill_tokens=32,
            max_model_len=256, quantization="int8")
PROMPTS = [[1, 2, 3], [9, 8, 7, 6], [42] * 10, [5, 5, 5, 5, 5]]


async def _gen(engine, prompt):
    req = {"token_ids": prompt, "sampling_options": {"temperature": 0.0},
           "stop_conditions": {"max_tokens": 6, "ignore_eos": True}}
    toks = []
    async for out in engine.generate(req):
        assert out.get("finish_reason") != "error", out
        toks += out["token_ids"]
    return toks


@pytest.mark.parametrize("steps", [1, 4])
def test_int8_engine_greedy_equals_jax_engine(steps):
    cfg_j, params, _, cfg_t = _jax_and_port(dict(TINY), quantized=False)
    model = tl.params_from_jax(cfg_t, jax.tree.map(np.asarray, params),
                               device="cpu")

    async def run():
        jeng = JaxEngine(cfg_j, params, JaxEngineConfig(**ECFG),
                         eos_token_ids=[], kv_dtype=jnp.float32)
        want = [await _gen(jeng, p) for p in PROMPTS]
        await jeng.shutdown()
        teng = TorchEngine(cfg_t, model, EngineConfig(**ECFG, decode_steps=steps),
                           eos_token_ids=[], device="cpu")
        got = list(await asyncio.gather(*[_gen(teng, p) for p in PROMPTS]))
        await teng.shutdown()
        return want, got

    want, got = asyncio.run(run())
    assert all(tq.is_quantized(getattr(model.layers[0], k)) for k in tq.QUANT_KEYS)
    assert got == want


def test_random_int8_params_layout():
    cfg = tcfg.tiny_config()
    rnd = tq.random_int8_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    ref = tq.quantize_params(tl.init_params(cfg, torch.Generator().manual_seed(0),
                                            torch.bfloat16, "cpu"))
    for a, b in zip(rnd.layers, ref.layers):
        for k in tq.QUANT_KEYS:
            x, y = getattr(a, k), getattr(b, k)
            for part in ("q", "s"):
                assert x[part].shape == y[part].shape and x[part].dtype == y[part].dtype
    assert rnd.lm_head["q"].shape == ref.lm_head["q"].shape
    assert rnd.lm_head["q"].abs().max() <= 127
    out = rnd.forward_prefill(tl.KVCache.create(cfg, 3, 8, torch.bfloat16, "cpu"),
                              torch.tensor([[1, 2, 3]]),
                              torch.tensor([[1, 2]], dtype=torch.int32),
                              torch.zeros(1, dtype=torch.int32),
                              torch.tensor([3], dtype=torch.int32))
    assert out.shape == (1, cfg.vocab_size) and torch.isfinite(out).all()

"""The port's model breadth against the JAX package on the same weights
(moved across with `params_from_jax`), f32 tiny configs on the CPU:

- `forward_prefill` (two chunks, the second over a cached prefix; the
  prompt crosses the window), eight greedy `forward_decode` steps and a
  `forward_verify` chunk, for a gpt-oss-like config (windows [8, 0, 8,
  0], sinks, q/k/v/o biases, biased router, clamped-GLU experts, yarn
  rope), a qwen-like one (q/k/v biases), a mistral-like one (a window on
  every layer) and a mixtral-like one (silu experts): logits and the KV
  pool within 1e-5, greedy tokens identical;
- `TorchEngine` greedy tokens equal to `JaxEngine`'s for a tiny gpt-oss,
  with one-step and four-step decode blocks;
- the loader: the port's MXFP4 dequant/quant bit-equal to JAX's; a
  synthetic MXFP4 gpt-oss checkpoint, a qwen2-bias checkpoint and a
  mixtral-layout checkpoint load to the JAX loader's weights exactly and
  to its prefill logits within 1e-4; a bias the config does not declare
  is refused by both loaders.
"""

import asyncio
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxEngine
from dynamo_tpu.models import config as jcfg
from dynamo_tpu.models import llama as jl
from dynamo_tpu.models import mxfp4 as jmx
from dynamo_tpu.models.loader import load_params as jax_load_params
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.models import config as tcfg
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models import mxfp4 as tmx
from dynamo_tpu_torch.models.loader import load_params

PAGE, MAXP = 8, 8
ATOL = 1e-5
YARN = {"rope_type": "yarn", "factor": 32.0, "beta_fast": 32.0,
        "beta_slow": 1.0, "original_max_position_embeddings": 4096,
        "truncate": False}
TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=96,
            num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
            head_dim=16, max_position_embeddings=512)
CONFIGS = {
    "gpt_oss": dict(
        TINY, sliding_window=8,
        layer_types=("sliding_attention", "full_attention") * 2,
        attention_bias=True, attention_out_bias=True, attention_sinks=True,
        num_experts=8, num_experts_per_tok=2, moe_act="gpt_oss_glu",
        moe_bias=True, rope_theta=150000.0, rope_scaling=YARN,
        model_type="gpt_oss", name="tiny-gpt-oss"),
    "qwen": dict(TINY, attention_bias=True, model_type="qwen2",
                 name="tiny-qwen"),
    "mistral": dict(TINY, sliding_window=8, model_type="mistral",
                    name="tiny-mistral"),
    "mixtral": dict(TINY, num_experts=4, num_experts_per_tok=2,
                    model_type="mixtral", name="tiny-mixtral"),
}


def _configs(name, **over):
    kw = {**CONFIGS[name], **over}
    return jcfg.ModelConfig(**kw), tcfg.ModelConfig(**kw)


def _models(name, seed=0, **over):
    cfg_j, cfg_t = _configs(name, **over)
    params = jl.init_params(cfg_j, jax.random.PRNGKey(seed), dtype=jnp.float32)
    model = tl.params_from_jax(cfg_t, jax.tree.map(np.asarray, params),
                               device="cpu")
    return cfg_j, params, cfg_t, model


def _i32(x):
    return torch.tensor(x, dtype=torch.int32)


def _run_both(name):
    """Both packages through two prefill chunks (row 1 shorter), a verify
    chunk of 4 on each row and 8 greedy decode steps; returns the pairs
    (JAX, port) of every logits array, the token streams and the pools."""
    cfg_j, params, cfg_t, model = _models(name)
    rng = np.random.default_rng(0)
    B, S1, S2 = 2, 16, 8
    toks = rng.integers(0, cfg_j.vocab_size, (B, S1 + S2 + 8)).astype(np.int32)
    table = np.arange(1, 1 + B * MAXP, dtype=np.int32).reshape(B, MAXP)
    P = 1 + B * MAXP
    kv_j = jl.KVCache.create(cfg_j, P, PAGE, jnp.float32)
    kv_t = tl.KVCache.create(cfg_t, P, PAGE, torch.float32, "cpu")
    pairs = []
    lens = [0, 0]
    for cl in ([S1, 11], [S2, 5]):
        t = np.stack([toks[b, lens[b]:lens[b] + max(cl)] for b in range(B)])
        lj, kv_j = jl.forward_prefill(params, cfg_j, kv_j, jnp.asarray(t),
                                      jnp.asarray(table), jnp.asarray(lens, jnp.int32),
                                      jnp.asarray(cl, jnp.int32))
        lt = model.forward_prefill(kv_t, torch.from_numpy(t).long(),
                                   torch.from_numpy(table), _i32(lens), _i32(cl))
        pairs.append((np.asarray(lj), lt.numpy()))
        lens = [a + b for a, b in zip(lens, cl)]
    # a verify chunk of 4 tokens: logits at every position, KV written
    t = np.stack([toks[b, lens[b]:lens[b] + 4] for b in range(B)])
    lj, kv_j = jl.forward_verify(params, cfg_j, kv_j, jnp.asarray(t),
                                 jnp.asarray(table), jnp.asarray(lens, jnp.int32),
                                 jnp.asarray([4, 4], jnp.int32))
    lt = model.forward_verify(kv_t, torch.from_numpy(t).long(),
                              torch.from_numpy(table), _i32(lens), _i32([4, 4]))
    pairs.append((np.asarray(lj), lt.numpy()))
    pos = np.asarray(lens, np.int32) + 4
    tok_j = jnp.argmax(jnp.asarray(pairs[-1][0][:, -1]), -1).astype(jnp.int32)
    tok_t = torch.from_numpy(np.argmax(pairs[-1][1][:, -1], -1))
    toks_j, toks_t = [], []
    for s in range(8):
        lj, kv_j = jl.forward_decode(params, cfg_j, kv_j, tok_j,
                                     jnp.asarray(pos + s), jnp.asarray(table))
        lt = model.forward_decode(kv_t, tok_t, torch.from_numpy(pos + s).long(),
                                  torch.from_numpy(table))
        pairs.append((np.asarray(lj), lt.numpy()))
        tok_j = jnp.argmax(lj, -1).astype(jnp.int32)
        tok_t = lt.argmax(-1)
        toks_j.append(np.asarray(tok_j))
        toks_t.append(tok_t.numpy())
    return pairs, np.stack(toks_j), np.stack(toks_t), kv_j, kv_t


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forwards_match_jax(name):
    pairs, toks_j, toks_t, kv_j, kv_t = _run_both(name)
    for i, (lj, lt) in enumerate(pairs):
        np.testing.assert_allclose(lt, lj, atol=ATOL, rtol=ATOL,
                                   err_msg=f"{name}: logits {i}")
    np.testing.assert_array_equal(toks_t, toks_j)
    np.testing.assert_allclose(kv_t.k.numpy()[:, 1:], np.asarray(kv_j.k)[:, 1:],
                               atol=ATOL)
    np.testing.assert_allclose(kv_t.v.numpy()[:, 1:], np.asarray(kv_j.v)[:, 1:],
                               atol=ATOL)


@pytest.mark.parametrize("impl", ["dense", "capacity"])
def test_gpt_oss_other_moe_impls_match_jax(impl):
    """The prefill logits of the dense oracle and the capacity dispatch
    (capacity 8: nothing dropped at this size) equal JAX's on the same
    config, and the ragged default's."""
    logits = {}
    for moe_impl in ("ragged", impl):
        over = {"moe_impl": moe_impl, "moe_capacity_factor": 8.0}
        cfg_j, params, cfg_t, model = _models("gpt_oss", **over)
        toks = np.random.default_rng(4).integers(0, 256, (1, 20)).astype(np.int32)
        n = 1 + 4
        kv_j = jl.KVCache.create(cfg_j, n, PAGE, jnp.float32)
        kv_t = tl.KVCache.create(cfg_t, n, PAGE, torch.float32, "cpu")
        table = np.arange(1, n, dtype=np.int32)[None]
        lj, _ = jl.forward_prefill(params, cfg_j, kv_j, jnp.asarray(toks),
                                   jnp.asarray(table), jnp.zeros(1, jnp.int32),
                                   jnp.asarray([20], jnp.int32))
        lt = model.forward_prefill(kv_t, torch.from_numpy(toks).long(),
                                   torch.from_numpy(table), _i32([0]), _i32([20]))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL, rtol=ATOL)
        logits[moe_impl] = lt.numpy()
    np.testing.assert_allclose(logits[impl], logits["ragged"], atol=1e-4)


# --------------------------------------------------------------------------- #
# the engine
# --------------------------------------------------------------------------- #

ECFG = dict(page_size=8, num_pages=64, max_num_seqs=2, max_prefill_tokens=64,
            max_model_len=64)
PROMPTS = [[5, 9, 13, 17], [6, 9, 13, 17], [(3 * j + 1) % 256 for j in range(20)]]


async def _gen(engine, prompt, max_tokens=6):
    req = {"token_ids": prompt, "sampling_options": {"temperature": 0.0},
           "stop_conditions": {"max_tokens": max_tokens, "ignore_eos": True}}
    toks = []
    async for out in engine.generate(req):
        assert out.get("finish_reason") != "error", out
        toks += out["token_ids"]
    return toks


@pytest.mark.parametrize("steps", [1, 4])
def test_gpt_oss_engine_greedy_equals_jax_engine(steps):
    """Greedy tokens of `TorchEngine` over a tiny gpt-oss (sinks, windows
    crossed by a 20-token prompt, biased MoE through the ragged dispatch)
    equal `JaxEngine`'s, alone and batched."""
    cfg_j, params, cfg_t, model = _models("gpt_oss")

    async def run():
        jeng = JaxEngine(cfg_j, params, JaxEngineConfig(**ECFG),
                         eos_token_ids=[], kv_dtype=jnp.float32)
        want = [await _gen(jeng, p) for p in PROMPTS]
        await jeng.shutdown()
        teng = TorchEngine(cfg_t, model, EngineConfig(**ECFG, decode_steps=steps),
                           eos_token_ids=[], device="cpu")
        solo = [await _gen(teng, p) for p in PROMPTS]
        both = await asyncio.gather(*[_gen(teng, p) for p in PROMPTS])
        await teng.shutdown()
        return want, solo, list(both)

    want, solo, both = asyncio.run(run())
    assert solo == want
    assert both == want


# --------------------------------------------------------------------------- #
# the loader
# --------------------------------------------------------------------------- #


def test_mxfp4_dequant_and_quant_bit_equal_jax():
    rng = np.random.default_rng(3)
    blocks = rng.integers(0, 256, size=(4, 6, 2, 16), dtype=np.uint8)
    scales = rng.integers(110, 140, size=(4, 6, 2), dtype=np.uint8)
    np.testing.assert_array_equal(tmx.dequant_mxfp4(blocks, scales),
                                  jmx.dequant_mxfp4(blocks, scales))
    w = rng.normal(size=(3, 64, 24)).astype(np.float32)
    for got, want in zip(tmx.quant_mxfp4(w), jmx.quant_mxfp4(w)):
        assert got.dtype == want.dtype and got.flags["C_CONTIGUOUS"]
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tmx.FP4_VALUES, jmx.FP4_VALUES)


def _hf_config(name):
    c = CONFIGS[name]
    d = {"vocab_size": c["vocab_size"], "hidden_size": c["hidden_size"],
         "intermediate_size": c["intermediate_size"],
         "num_hidden_layers": c["num_hidden_layers"],
         "num_attention_heads": c["num_attention_heads"],
         "num_key_value_heads": c["num_key_value_heads"],
         "head_dim": c["head_dim"], "rms_norm_eps": 1e-5,
         "rope_theta": c.get("rope_theta", 10000.0),
         "max_position_embeddings": 512, "tie_word_embeddings": False,
         "model_type": c["model_type"]}
    if name == "gpt_oss":
        d.update(sliding_window=8, layer_types=list(c["layer_types"]),
                 num_local_experts=8, num_experts_per_tok=2,
                 rope_scaling=dict(YARN), attention_bias=True)
    if name == "mixtral":
        d.update(num_local_experts=4, num_experts_per_tok=2)
    return d


def _write_checkpoint(path, name, mxfp4=False, seed=0):
    """A checkpoint in the published layout of `name`'s family, random
    weights from `seed` (MXFP4 experts snapped to representable values:
    the check is the format path, not quantization error)."""
    from safetensors.numpy import save_file

    d = _hf_config(name)
    rng = np.random.default_rng(seed)
    h, f, L = d["hidden_size"], d["intermediate_size"], d["num_hidden_layers"]
    hd, nh, nkv = d["head_dim"], d["num_attention_heads"], d["num_key_value_heads"]

    def w(*shape, scale=None):
        s = scale or 1.0 / np.sqrt(shape[-1])
        return np.ascontiguousarray((rng.normal(size=shape) * s).astype(np.float32))

    t = {"model.embed_tokens.weight": w(d["vocab_size"], h, scale=0.5),
         "model.norm.weight": 1 + w(h, scale=0.1),
         "lm_head.weight": w(d["vocab_size"], h)}
    for i in range(L):
        p = f"model.layers.{i}."
        t[p + "self_attn.q_proj.weight"] = w(nh * hd, h)
        t[p + "self_attn.k_proj.weight"] = w(nkv * hd, h)
        t[p + "self_attn.v_proj.weight"] = w(nkv * hd, h)
        t[p + "self_attn.o_proj.weight"] = w(h, nh * hd)
        t[p + "input_layernorm.weight"] = 1 + w(h, scale=0.1)
        t[p + "post_attention_layernorm.weight"] = 1 + w(h, scale=0.1)
        if name in ("gpt_oss", "qwen"):
            t[p + "self_attn.q_proj.bias"] = w(nh * hd, scale=0.1)
            t[p + "self_attn.k_proj.bias"] = w(nkv * hd, scale=0.1)
            t[p + "self_attn.v_proj.bias"] = w(nkv * hd, scale=0.1)
        if name == "gpt_oss":
            E = d["num_local_experts"]
            t[p + "self_attn.o_proj.bias"] = w(h, scale=0.1)
            t[p + "self_attn.sinks"] = w(nh, scale=1.0)
            t[p + "mlp.router.weight"] = w(E, h)
            t[p + "mlp.router.bias"] = w(E, scale=0.1)
            t[p + "mlp.experts.gate_up_proj_bias"] = w(E, 2 * f, scale=0.1)
            t[p + "mlp.experts.down_proj_bias"] = w(E, h, scale=0.1)
            for proj, shape in (("gate_up_proj", (E, h, 2 * f)),
                                ("down_proj", (E, f, h))):
                a = w(*shape, scale=1.0 / np.sqrt(shape[1]))
                if mxfp4:
                    blocks, scales = jmx.quant_mxfp4(a)
                    t[p + f"mlp.experts.{proj}_blocks"] = blocks
                    t[p + f"mlp.experts.{proj}_scales"] = scales
                else:
                    t[p + f"mlp.experts.{proj}"] = a
        elif name == "mixtral":
            t[p + "block_sparse_moe.gate.weight"] = w(d["num_local_experts"], h)
            for e in range(d["num_local_experts"]):
                q = p + f"block_sparse_moe.experts.{e}."
                t[q + "w1.weight"] = w(f, h)
                t[q + "w3.weight"] = w(f, h)
                t[q + "w2.weight"] = w(h, f)
        else:
            t[p + "mlp.gate_proj.weight"] = w(f, h)
            t[p + "mlp.up_proj.weight"] = w(f, h)
            t[p + "mlp.down_proj.weight"] = w(h, f)
    save_file(t, os.path.join(path, "model.safetensors"))
    if mxfp4:
        d["quantization_config"] = {"quant_method": "mxfp4"}
    with open(os.path.join(path, "config.json"), "w") as fh:
        json.dump(d, fh)
    return d


def _prefill_logits_jax(params, cfg, toks):
    n = 1 + -(-toks.shape[1] // PAGE)
    kv = jl.KVCache.create(cfg, n, PAGE, jnp.float32)
    table = jnp.arange(1, n, dtype=jnp.int32)[None]
    logits, _ = jl.forward_prefill(params, cfg, kv, jnp.asarray(toks), table,
                                   jnp.zeros(1, jnp.int32),
                                   jnp.asarray([toks.shape[1]], jnp.int32))
    return np.asarray(logits)


def _prefill_logits_port(model, cfg, toks):
    n = 1 + -(-toks.shape[1] // PAGE)
    kv = tl.KVCache.create(cfg, n, PAGE, torch.float32, "cpu")
    table = torch.arange(1, n, dtype=torch.int32)[None]
    return model.forward_prefill(kv, torch.from_numpy(toks).long(), table,
                                 _i32([0]), _i32([toks.shape[1]])).numpy()


@pytest.mark.parametrize("case", ["gpt_oss_mxfp4", "gpt_oss_bf16_export",
                                  "qwen", "mixtral"])
def test_checkpoint_loads_like_jax(tmp_path, case):
    """The port's loader gives the JAX loader's weights exactly (through
    `params_from_jax`) and its prefill logits within 1e-4."""
    name = case.split("_bf16")[0].replace("_mxfp4", "")
    _write_checkpoint(str(tmp_path), name, mxfp4=case.endswith("mxfp4"))
    cfg_j = jcfg.ModelConfig.from_pretrained(str(tmp_path))
    cfg_t = tcfg.ModelConfig.from_pretrained(str(tmp_path))
    assert cfg_t == tcfg.ModelConfig(**cfg_j.__dict__)
    tree = jax_load_params(str(tmp_path), cfg_j, dtype=jnp.float32)
    got = load_params(str(tmp_path), cfg_t, dtype=torch.float32, device="cpu")
    want = tl.params_from_jax(cfg_t, jax.tree.map(np.asarray, tree), device="cpu")
    for (n_got, p_got), (n_want, p_want) in zip(got.named_parameters(),
                                                want.named_parameters()):
        assert n_got == n_want
        assert torch.equal(p_got, p_want), n_got
    toks = np.random.default_rng(2).integers(0, 256, (1, 19)).astype(np.int32)
    np.testing.assert_allclose(_prefill_logits_port(got, cfg_t, toks),
                               _prefill_logits_jax(tree, cfg_j, toks),
                               atol=1e-4, rtol=1e-4)


def test_undeclared_bias_refused_by_both_loaders(tmp_path):
    """A qwen2 checkpoint whose config turns attention_bias off: both
    loaders refuse to drop the bias tensors."""
    d = _write_checkpoint(str(tmp_path), "qwen")
    d["attention_bias"] = False
    with pytest.raises(ValueError, match="does not declare attention_bias"):
        jax_load_params(str(tmp_path), jcfg.ModelConfig.from_hf_config(d),
                        dtype=jnp.float32)
    with pytest.raises(ValueError, match="does not declare attention_bias"):
        load_params(str(tmp_path), tcfg.ModelConfig.from_hf_config(d),
                    dtype=torch.float32, device="cpu")

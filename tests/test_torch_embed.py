"""Embeddings in the port against the JAX package, on the CPU, on the same
weights (the JAX `init_params` tree moved across with `params_from_jax`)
and the same seeded numpy inputs:

- `Llama.forward_embed` against JAX `forward_embed`: a dense tiny config
  in f32 (within 1e-5) and bf16 (within the `allclose` tolerance below),
  and a gpt-oss-like config (windows, sinks, biases, MoE) in f32, on
  ragged lengths down to 1;
- `TorchEngine.embed` against `JaxEngine.embed`: vectors, `prompt_tokens`,
  truncation past max_model_len, "no inputs"; a row's vector the same
  alone, in a batch and in another row group; an embed issued while a
  greedy `generate` streams leaves that stream's tokens unchanged;
- `preprocess_embedding` against JAX's for every input form and error;
- `/v1/embeddings` through the port's frontend and the JAX frontend, both
  routing to one port worker on one control plane: the same bodies and
  statuses (404, 400 for a card without ``embedding`` and for bad input,
  500 for a worker's error), and the contract checks of the JAX API test.
"""

import asyncio
import math

import aiohttp
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxEngine
from dynamo_tpu.frontend import HttpService as JaxHttpService
from dynamo_tpu.frontend import ModelManager as JaxModelManager
from dynamo_tpu.frontend import ModelWatcher as JaxModelWatcher
from dynamo_tpu.llm import ModelDeploymentCard as JaxCard
from dynamo_tpu.llm import OpenAIPreprocessor as JaxPreprocessor
from dynamo_tpu.llm import RequestError as JaxRequestError
from dynamo_tpu.models import config as jcfg
from dynamo_tpu.models import llama as jl
from dynamo_tpu.runtime import ControlPlaneServer as JaxControlPlane
from dynamo_tpu.runtime import DistributedRuntime as JaxRuntime
from dynamo_tpu.testing import tiny_tokenizer as jax_tiny_tokenizer
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.frontend import HttpService, ModelManager, ModelWatcher
from dynamo_tpu_torch.llm import ModelDeploymentCard, OpenAIPreprocessor, RequestError
from dynamo_tpu_torch.models import config as tcfg
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.runtime import DistributedRuntime
from dynamo_tpu_torch.testing import tiny_tokenizer
from dynamo_tpu_torch.worker import serve_engine

T = 60  # seconds, every network wait
F32_ATOL = 1e-5
# bf16: both sides round every layer's activations to 8 bits of mantissa
# (~4e-3 relative) in their own op order; 32 positions x 2 layers of it on
# unit vectors of 64 components stay well inside 2e-2
BF16_ATOL = 2e-2
GPT_OSS = dict(vocab_size=256, hidden_size=64, intermediate_size=96,
               num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
               head_dim=16, max_position_embeddings=512, sliding_window=8,
               layer_types=("sliding_attention", "full_attention") * 2,
               attention_bias=True, attention_out_bias=True,
               attention_sinks=True, num_experts=8, num_experts_per_tok=2,
               moe_act="gpt_oss_glu", moe_bias=True, rope_theta=150000.0,
               model_type="gpt_oss", name="tiny-gpt-oss")
ECFG = dict(page_size=8, num_pages=64, max_num_seqs=4, max_prefill_tokens=32,
            max_model_len=96)
MODEL = "tiny-chat"


def _models(kind, jdtype):
    if kind == "gpt_oss":
        cfg_j, cfg_t = jcfg.ModelConfig(**GPT_OSS), tcfg.ModelConfig(**GPT_OSS)
    else:
        tok = jax_tiny_tokenizer()
        cfg_j = jcfg.tiny_config(vocab_size=tok.vocab_size)
        cfg_t = tcfg.tiny_config(vocab_size=tok.vocab_size)
    params = jl.init_params(cfg_j, jax.random.PRNGKey(3), dtype=jdtype)
    model = tl.params_from_jax(cfg_t, jax.tree.map(np.asarray, params),
                               device="cpu")
    return cfg_j, params, cfg_t, model


@pytest.fixture(scope="module")
def dense():
    """The tiny dense model in f32 (JAX params, port model)."""
    return _models("dense", jnp.float32)


def _inputs(vocab, B=5, S=32, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S)).astype(np.int32)
    lens = np.array([S, 1, 17, 9, 2][:B], np.int32)
    return toks, lens


@pytest.mark.parametrize("kind,jdtype,atol", [
    ("dense", jnp.float32, F32_ATOL),
    ("dense", jnp.bfloat16, BF16_ATOL),
    ("gpt_oss", jnp.float32, F32_ATOL),
], ids=["dense_f32", "dense_bf16", "gpt_oss_f32"])
def test_forward_embed_matches_jax(kind, jdtype, atol):
    cfg_j, params, cfg_t, model = _models(kind, jdtype)
    toks, lens = _inputs(cfg_j.vocab_size)
    want = np.asarray(jl.forward_embed(params, cfg_j, jnp.asarray(toks),
                                       jnp.asarray(lens)), np.float32)
    got = model.forward_embed(torch.from_numpy(toks).long(),
                              torch.from_numpy(lens)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    # positions past a row's length change nothing
    toks2 = toks.copy()
    for i, n in enumerate(lens):
        toks2[i, n:] = 7
    again = model.forward_embed(torch.from_numpy(toks2).long(),
                                torch.from_numpy(lens)).numpy()
    np.testing.assert_allclose(again, got, atol=atol * 1e-2, rtol=0)


def _jax_engine(cfg_j, params):
    return JaxEngine(cfg_j, params, JaxEngineConfig(**ECFG), eos_token_ids=[],
                     kv_dtype=jnp.float32)


def _port_engine(cfg_t, model, **over):
    return TorchEngine(cfg_t, model, EngineConfig(**{**ECFG, **over}),
                       eos_token_ids=[], device="cpu")


async def test_engine_embed_matches_jax(dense):
    """Vectors, prompt_tokens, truncation and the empty request; then a
    row's vector alone, in a batch and in another row group."""
    cfg_j, params, cfg_t, model = dense
    rng = np.random.default_rng(1)
    rows = [rng.integers(1, cfg_j.vocab_size, n).tolist()
            for n in (5, 40, 1, 96, 130, 23)]  # 130 > max_model_len
    je, te = _jax_engine(cfg_j, params), _port_engine(cfg_t, model)
    # a budget of 96 tokens cuts the six rows into several groups
    small = _port_engine(cfg_t, model, max_num_seqs=1)
    assert small.embed_token_budget == 96 < te.embed_token_budget
    try:
        for req in ({"embed_token_ids": rows}, {"embed_token_ids": rows[:3]},
                    {"embed_token_ids": [rows[4]]}):
            want = await je.embed(req)
            got = await te.embed(req)
            assert got["prompt_tokens"] == want["prompt_tokens"]
            np.testing.assert_allclose(np.array(got["embeddings"]),
                                       np.array(want["embeddings"]),
                                       atol=F32_ATOL, rtol=0)
        full = await te.embed({"embed_token_ids": rows})
        assert full["prompt_tokens"] == 5 + 40 + 1 + 96 + 96 + 23
        for bad in ({}, {"embed_token_ids": []}):
            assert await te.embed(bad) == await je.embed(bad) == {
                "error": "no inputs"}
        # a row alone, in the batch, and in the small engine's groups
        grouped = await small.embed({"embed_token_ids": rows})
        for i, r in enumerate(rows):
            alone = (await te.embed({"embed_token_ids": [r]}))["embeddings"][0]
            np.testing.assert_allclose(full["embeddings"][i], alone,
                                       atol=1e-6, rtol=0)
            np.testing.assert_allclose(grouped["embeddings"][i], alone,
                                       atol=1e-6, rtol=0)
    finally:
        for e in (je, te, small):
            await e.shutdown()


async def test_embed_between_steps_leaves_a_stream_unchanged(dense):
    """An embed issued while a greedy generate streams runs between its
    steps: the stream's tokens equal an undisturbed run's."""
    _, _, cfg_t, model = dense
    te = _port_engine(cfg_t, model)
    req = {"token_ids": list(range(3, 40)),
           "sampling_options": {"temperature": 0.0},
           "stop_conditions": {"max_tokens": 24, "ignore_eos": True}}

    async def run(embed_after=None):
        toks, embeds = [], []
        async for out in te.generate(dict(req)):
            toks += out["token_ids"]
            if embed_after is not None and len(toks) >= embed_after and not embeds:
                embeds.append(await te.embed(
                    {"embed_token_ids": [list(range(5, 70)), [9, 8, 7]]}))
        return toks, embeds

    try:
        alone, _ = await run()
        disturbed, embeds = await run(embed_after=4)
        assert len(alone) == 24 and disturbed == alone
        assert embeds and len(embeds[0]["embeddings"]) == 2
    finally:
        await te.shutdown()


EMBED_INPUTS = {
    "string": {"input": "hello world"},
    "strings": {"input": ["hello", "the quick brown fox"]},
    "token_array": {"input": [5, 9, 17]},
    "token_arrays": {"input": [[5, 9], [17, 23, 4]]},
    "mixed": {"input": ["hello", [3, 4]]},
    "missing": {},
    "empty_list": {"input": []},
    "not_a_list": {"input": 5},
    "too_many": {"input": ["x"] * 65},
    "at_cap": {"input": ["x"] * 64},
    "empty_string": {"input": [""]},
    "empty_tokens": {"input": [[]]},
    "bad_item": {"input": [1.5]},
    "bad_token": {"input": [[1, "a"]]},
    "over_context": {"input": [list(range(65))]},
    "at_context": {"input": [list(range(64))]},
}


@pytest.mark.parametrize("name", sorted(EMBED_INPUTS))
def test_preprocess_embedding_matches_jax(name):
    jtok, ttok = jax_tiny_tokenizer(), tiny_tokenizer()
    jpre = JaxPreprocessor(JaxCard(name="m", context_length=64), jtok)
    tpre = OpenAIPreprocessor(ModelDeploymentCard(name="m", context_length=64), ttok)
    body = EMBED_INPUTS[name]
    try:
        want = ("ok", jpre.preprocess_embedding(dict(body)))
    except JaxRequestError as e:
        want = ("error", str(e))
    try:
        got = ("ok", tpre.preprocess_embedding(dict(body)))
    except RequestError as e:
        got = ("error", str(e))
    assert got == want


class _NoEmbed:
    """An engine without `embed` (its worker answers an error)."""

    async def generate(self, request, context=None):
        yield {"token_ids": [], "finish_reason": "stop"}


async def _post(session, base, body):
    async def go():
        async with session.post(base + "/v1/embeddings", json=body) as r:
            return r.status, await r.json(content_type=None)
    return await asyncio.wait_for(go(), T)


async def test_http_embeddings_port_frontend_matches_jax(dense):
    """One JAX control plane; one port worker serves the model (its card
    advertises ``embedding``), a second port worker serves a card without
    it and a third one whose engine has no embed.  The port's frontend and
    the JAX frontend answer the same bodies and statuses."""
    _, _, cfg_t, model = dense
    tok = tiny_tokenizer()
    control = await JaxControlPlane().start()
    rts = [await DistributedRuntime.connect(control.address) for _ in range(3)]
    engine = _port_engine(cfg_t, model)
    cards = [ModelDeploymentCard(name=n, tokenizer_json=tok.to_json_str(),
                                 model_type=t)
             for n, t in ((MODEL, "chat,completions"),
                          ("no-embed", "chat,completions"),
                          ("broken", "chat,completions,embedding"))]
    served = [await serve_engine(rts[0], engine, cards[0]),
              await serve_engine(rts[1], _NoEmbed(), cards[1]),
              await serve_engine(rts[2], _NoEmbed(), cards[2])]
    assert served and cards[0].model_type == "chat,completions,embedding"
    assert cards[1].model_type == "chat,completions"
    jrt = await JaxRuntime.connect(control.address)
    prt = await DistributedRuntime.connect(control.address)
    jw = await JaxModelWatcher(jrt, JaxModelManager()).start()
    pw = await ModelWatcher(prt, ModelManager()).start()
    for w in (jw, pw):
        for c in cards:
            await asyncio.wait_for(w.wait_for_model(c.name), T)
    jh = await JaxHttpService(jw.manager, host="127.0.0.1", port=0).start()
    ph = await HttpService(pw.manager, host="127.0.0.1", port=0).start()
    bases = [f"http://127.0.0.1:{h.port}" for h in (jh, ph)]
    cases = [
        {"model": MODEL, "input": ["hello world", "hello world",
                                   "completely different text 123"]},
        {"model": MODEL, "input": [5, 9, 17, 23]},
        {"model": MODEL, "input": [[5, 9], list(range(1, 90))]},
        {"model": "nope", "input": "x"},
        {"model": "no-embed", "input": "x"},
        {"model": MODEL, "input": [""]},
        {"model": MODEL, "input": ["x"] * 65},
        {"model": "broken", "input": "x"},
    ]
    try:
        async with aiohttp.ClientSession() as s:
            answers = []
            for body in cases:
                got = [await _post(s, b, body) for b in bases]
                assert got[1] == got[0], body
                answers.append(got[1])
            assert [a[0] for a in answers] == [200, 200, 200, 404, 400, 400,
                                               400, 500]
            data = answers[0][1]
            assert data["object"] == "list" and data["model"] == MODEL
            vecs = [d["embedding"] for d in data["data"]]
            assert [d["index"] for d in data["data"]] == [0, 1, 2]
            assert all(d["object"] == "embedding" for d in data["data"])
            ptoks = data["usage"]["prompt_tokens"]
            assert ptoks > 0 and data["usage"]["total_tokens"] == ptoks

            def cos(a, b):
                dot = sum(x * y for x, y in zip(a, b))
                return dot / (math.sqrt(sum(x * x for x in a))
                              * math.sqrt(sum(x * x for x in b)))

            assert cos(vecs[0], vecs[1]) > 0.999  # identical inputs
            assert cos(vecs[0], vecs[2]) < cos(vecs[0], vecs[1])
            # the worker's answer is the engine's own
            direct = await engine.embed({"embed_token_ids": [[5, 9, 17, 23]]})
            assert answers[1][1]["data"][0]["embedding"] == direct["embeddings"][0]
            assert answers[1][1]["usage"]["prompt_tokens"] == 4
            async with s.get(bases[1] + "/metrics") as r:
                text = await r.text()
            for status, n in (("200", 3), ("404", 1), ("400", 2), ("500", 1)):
                model = {"404": "nope", "500": "broken"}.get(status, MODEL)
                line = (f'dynamo_frontend_requests_total{{model="{model}",'
                        f'kind="embedding",status="{status}"}} {float(n)!r}')
                assert line in text, line
    finally:
        await ph.stop()
        await jh.stop()
        await pw.stop()
        await jw.stop()
        await engine.shutdown()
        for rt in (prt, *rts):
            await rt.shutdown(graceful=False)
        await jrt.shutdown(graceful=False)
        await control.stop()

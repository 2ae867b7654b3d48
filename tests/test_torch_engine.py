"""TorchEngine (dynamo_tpu_torch.engine) on the CPU, tiny f32 config.

The engine's serving behaviour (single and concurrent generation, prefix
cache, stop tokens, long-prompt rejection, kill, a balanced pool at
shutdown), and greedy and seeded-sampling identity with the JAX package's
JaxEngine on the same weights, for the prompts of tests/test_engine.py.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxEngine
from dynamo_tpu.models import init_params as jax_init_params
from dynamo_tpu.models import tiny_config as jax_tiny_config
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.models import params_from_jax, tiny_config
from dynamo_tpu_torch.runtime import Context

PROMPTS = [[1, 2, 3], [9, 8, 7, 6], [42] * 10, [5, 5, 5, 5, 5]]
ECFG = dict(page_size=8, num_pages=64, max_num_seqs=4, max_prefill_tokens=32,
            max_model_len=256)


@pytest.fixture(scope="module")
def jax_params():
    return jax_init_params(jax_tiny_config(), jax.random.PRNGKey(0),
                           dtype=jnp.float32)


def make_engine(jax_params, **over):
    cfg = tiny_config()
    model = params_from_jax(cfg, jax.tree.map(np.asarray, jax_params),
                            device="cpu")
    return TorchEngine(cfg, model, EngineConfig(**{**ECFG, **over}),
                       eos_token_ids=[], device="cpu")


def req(tokens, max_tokens=8, temperature=0.0, **so):
    return {"token_ids": tokens,
            "sampling_options": {"temperature": temperature, **so},
            "stop_conditions": {"max_tokens": max_tokens, "ignore_eos": True}}


async def collect(engine, request, context=None):
    out, reason = [], None
    async for delta in engine.generate(request, context):
        out.extend(delta["token_ids"])
        reason = delta["finish_reason"]
    return out, reason


async def test_single_generation(jax_params):
    engine = make_engine(jax_params)
    tokens, reason = await collect(engine, req([1, 2, 3, 4, 5], max_tokens=6))
    assert len(tokens) == 6 and reason == "length"
    await engine.shutdown()


async def test_concurrent_matches_solo_and_jax_engine(jax_params):
    """Continuous batching does not change greedy outputs, and they are
    the JAX engine's tokens on the same weights."""
    engine = make_engine(jax_params)
    solo = [(await collect(engine, req(p, max_tokens=5)))[0] for p in PROMPTS]
    both = await asyncio.gather(*[collect(engine, req(p, max_tokens=5))
                                  for p in PROMPTS])
    assert [t for t, _ in both] == solo
    await engine.shutdown()

    jeng = JaxEngine(jax_tiny_config(), jax_params, JaxEngineConfig(**ECFG),
                     eos_token_ids=[], kv_dtype=jnp.float32)
    want = []
    for p in PROMPTS:
        toks = []
        async for d in jeng.generate(req(p, max_tokens=5)):
            toks.extend(d["token_ids"])
        want.append(toks)
    await jeng.shutdown()
    assert solo == want


async def test_prefix_cache_hit(jax_params):
    engine = make_engine(jax_params)
    prompt = list(range(1, 33))  # 4 full pages
    t1, _ = await collect(engine, req(prompt, max_tokens=4))
    assert engine.pool.evictable_pages > 0
    t2, _ = await collect(engine, req(prompt, max_tokens=4))
    assert t1 == t2
    # the whole prompt but its last page came from the cache
    assert engine.metrics().prefix_cached_tokens_total == 24
    await engine.shutdown()


async def test_stop_token_and_seeded_reproducibility(jax_params):
    engine = make_engine(jax_params)
    first, _ = await collect(engine, req([7, 7, 7], max_tokens=8))
    r = req([7, 7, 7], max_tokens=8)
    stop = first[2]
    r["stop_conditions"]["stop_token_ids"] = [stop]
    toks, reason = await collect(engine, r)
    assert reason == "stop" and toks == first[:first.index(stop) + 1]
    seeded = req([3, 1, 4, 1, 5], max_tokens=6, temperature=0.9, seed=11)
    a, _ = await collect(engine, seeded)
    b, _ = await asyncio.gather(collect(engine, seeded),
                                collect(engine, req([2, 7, 1], max_tokens=6,
                                                    temperature=0.7, seed=3)))
    assert a == b[0]
    await engine.shutdown()


async def test_seeded_request_token_identical_to_jax_engine(jax_params):
    """A seeded temperature-0.9 request draws the JAX worker's tokens: both
    key each step by fold_in(PRNGKey(seed), tokens generated so far)."""
    r = req([3, 1, 4, 1, 5, 9, 2, 6], max_tokens=10, temperature=0.9, seed=11)
    engine = make_engine(jax_params)
    got, _ = await collect(engine, r)
    await engine.shutdown()
    jeng = JaxEngine(jax_tiny_config(), jax_params, JaxEngineConfig(**ECFG),
                     eos_token_ids=[], kv_dtype=jnp.float32)
    want = []
    async for d in jeng.generate(r):
        want.extend(d["token_ids"])
    await jeng.shutdown()
    assert len(got) == 10 and got == want
    assert len(set(got)) > 1


async def test_long_prompt_rejected(jax_params):
    engine = make_engine(jax_params)
    out = [d async for d in engine.generate(req(list(range(300))))]
    assert out[-1]["finish_reason"] == "error" and "prompt length" in out[-1]["error"]
    await engine.shutdown()


async def test_kill_cancels_and_pool_balanced(jax_params):
    engine = make_engine(jax_params)
    ctx = Context()
    out = []
    async for delta in engine.generate(req([1, 2, 3], max_tokens=200), ctx):
        out.append(delta)
        if len(out) == 2:
            ctx.kill()
    assert len(out) == 2
    await asyncio.sleep(0.2)
    assert engine.scheduler.num_requests() == (0, 0)
    # a stream abandoned right before shutdown is reaped by shutdown()
    gen = engine.generate(req([4, 5, 6], max_tokens=200))
    await gen.__anext__()
    await gen.aclose()
    await engine.shutdown()
    assert sum(engine.pool._refs.values()) == 0


@pytest.mark.parametrize("over,match", [
    ({"quantization": "int4"}, r"quantization must be none\|int8"),
    ({"kv_partition": True}, "requires a serving mesh")],
    ids=["other_weight_format", "kv_partition"])
def test_unported_engine_options_refused(jax_params, over, match):
    """A partitioned pool is refused on a flat engine, as JAX refuses it
    without a mesh (a dp group partitions it: tests/test_torch_dp*.py);
    int8 is served (tests/test_torch_quantization.py), so the
    other_weight_format case holds that formats other than none and int8
    are refused, as EngineConfig refuses them in JAX."""
    with pytest.raises(ValueError, match=match):
        make_engine(jax_params, **over)


def test_batch_launcher_on_cpu(tmp_path):
    import json
    import os

    from dynamo_tpu_torch.run.__main__ import main

    prompts = os.path.join(os.path.dirname(__file__), "fixtures",
                           "torch_prompts.jsonl")
    out = tmp_path / "out.jsonl"
    args = ["--in", "batch", "--model", "tiny", "--device", "cpu",
            "--input-file", prompts, "--output-file", str(out)]
    assert main(args) == 0
    rows = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert [r["index"] for r in rows] == [0, 1]
    assert [len(r["token_ids"]) for r in rows] == [3, 2]
    assert all(r["finish_reason"] == "length" for r in rows)
    assert main(args) == 0  # same seed, same weights: the same output
    assert [json.loads(ln) for ln in out.read_text().splitlines()] == rows

"""`TorchEngine(parallel=ParallelConfig(tp=2))` on a CPU gloo group of two
processes (the leader in the test process, one spawned follower) against
`JaxEngine(parallel=ParallelConfig(tp=2))` on two virtual CPU devices,
on the same seeded f32 weights and the prompts of
`tests/test_parallel_engine.py`: greedy tokens equal for a dense model,
MoE with its experts over the tp axis, int8, a speculative engine, and
multi-step blocks with the ladder, chains and ``decode_continuous``
(which takes the chained path under tp, as JAX's does under a mesh);
`embed` against JAX `forward_embed`; a follower that fails a dispatch,
before its model collectives or midway, fails the step's requests and
the group recovers, without a hang; ``tp=1`` is the flat engine."""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxEngine
from dynamo_tpu.models import config as jcfg
from dynamo_tpu.models import llama as jl
from dynamo_tpu.parallel import ParallelConfig as JaxParallelConfig
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine, lockstep
from dynamo_tpu_torch.models import config as tcfg
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.parallel import ParallelConfig, TreeShards
from dynamo_tpu_torch.parallel.sharding import save_tree

TP = 2
ECFG = dict(page_size=8, num_pages=128, max_num_seqs=8, max_prefill_tokens=32,
            max_model_len=128)
# arm -> (model, its JAX reference engine's options, the port's options):
# the speculative and multi-step arms are held to JAX's one-step engine
# (JAX's own tests hold its speculative and block paths to that engine)
ARMS = {
    "dense": ("tiny_config", {}, {}),
    "moe": ("tiny_moe_config", {}, {}),
    "int8": ("tiny_config", {"quantization": "int8"}, {"quantization": "int8"}),
    "spec": ("tiny_config", {}, {"speculative_ngram_k": 4}),
    "blocks": ("tiny_config", {}, {"decode_steps": 4,
                                   "decode_block_ladder": [1, 4],
                                   "decode_chain": 2, "decode_continuous": True}),
}


def _prompts(cfg, n=3):
    out = [[(i * 13 + j) % cfg.vocab_size for j in range(5 + 3 * i)]
           for i in range(n)]
    # one long prompt exercises chunked prefill (> max_prefill_tokens)
    out.append([(j * 7) % cfg.vocab_size for j in range(70)])
    return out


def _req(p, max_tokens=8):
    return {"token_ids": p, "sampling_options": {"temperature": 0.0},
            "stop_conditions": {"max_tokens": max_tokens, "ignore_eos": True}}


async def _collect(engine, prompts, max_tokens=8):
    async def one(p):
        toks, reason = [], None
        async for out in engine.generate(_req(p, max_tokens)):
            toks += out["token_ids"]
            reason = out["finish_reason"]
        return toks if reason != "error" else "error"

    return await asyncio.gather(*[one(p) for p in prompts])


def _setup(factory, tmp_path, seed=0):
    cfg_j, cfg_t = getattr(jcfg, factory)(), getattr(tcfg, factory)()
    params = jl.init_params(cfg_j, jax.random.PRNGKey(seed), dtype=jnp.float32)
    path = str(tmp_path / "tree.npz")
    save_tree(path, jax.tree.map(np.asarray, params))
    return cfg_j, params, cfg_t, TreeShards(cfg_t, path)


def _tp_engine(cfg_t, source, **over):
    return TorchEngine(cfg_t, source, EngineConfig(**{**ECFG, **over}),
                       parallel=ParallelConfig(tp=TP), devices=["cpu"] * TP)


@pytest.fixture(scope="module")
def jax_tp_tokens(tmp_path_factory):
    """(factory, JAX options) -> (the port's model source, the greedy
    tokens of a JaxEngine with ParallelConfig(tp=2)), each computed once."""
    done = {}

    def get(factory, jax_over):
        key = (factory, tuple(sorted(jax_over.items())))
        if key not in done:
            cfg_j, params, cfg_t, source = _setup(
                factory, tmp_path_factory.mktemp(factory))
            jeng = JaxEngine(cfg_j, params, JaxEngineConfig(**{**ECFG, **jax_over}),
                             kv_dtype=jnp.float32, devices=jax.devices()[:TP],
                             parallel=JaxParallelConfig(tp=TP))

            async def run():
                try:
                    return await _collect(jeng, _prompts(cfg_t))
                finally:
                    await jeng.shutdown()

            done[key] = (cfg_t, source, asyncio.run(run()))
        return done[key]

    return get


@pytest.mark.parametrize("arm", sorted(ARMS))
async def test_tp_engine_matches_jax_tp_engine(arm, jax_tp_tokens):
    factory, jax_over, over = ARMS[arm]
    cfg_t, source, want = await asyncio.get_running_loop().run_in_executor(
        None, jax_tp_tokens, factory, jax_over)
    prompts = _prompts(cfg_t)
    engine = _tp_engine(cfg_t, source, **over)
    try:
        got = await _collect(engine, prompts)
        m = engine.metrics()
        stats = engine.graphs.stats()
    finally:
        await engine.shutdown()
    assert got == want
    assert m.tp == TP and m.tp_backend == "gloo" and m.tp_plans_total > 0
    assert stats["mode"] == "eager"
    if arm == "blocks":  # chained, never the continuous loop
        assert m.decode_cc_chains_total == 0
        assert any(n > 1 for n in engine.rung_histogram)
    if arm == "spec":
        assert m.spec_dispatches_total > 0


async def test_tp_embed_matches_jax_forward_embed(tmp_path):
    cfg_j, params, cfg_t, source = _setup("tiny_config", tmp_path, seed=3)
    rows = [[(i * 11 + j) % cfg_t.vocab_size for j in range(n)]
            for i, n in enumerate([5, 17, 40])]
    engine = _tp_engine(cfg_t, source)
    try:
        got = await engine.embed({"embed_token_ids": rows})
    finally:
        await engine.shutdown()
    S = max(len(r) for r in rows)
    toks = np.zeros((len(rows), S), np.int32)
    for i, r in enumerate(rows):
        toks[i, :len(r)] = r
    want = np.asarray(jl.forward_embed(params, cfg_j, jnp.asarray(toks),
                                       jnp.asarray([len(r) for r in rows])))
    # the engine pads each group to its longest row, as JAX here
    np.testing.assert_allclose(np.asarray(got["embeddings"]), want,
                               rtol=2e-4, atol=2e-4)


def test_tp1_is_the_flat_engine():
    """`ParallelConfig(tp=1)` runs the flat path: same pool, captured
    graphs on a card, no group."""
    cfg = tcfg.tiny_config()
    model = tl.init_params(cfg, torch.Generator().manual_seed(0),
                           dtype=torch.float32, device="cpu")
    engine = TorchEngine(cfg, model, EngineConfig(**ECFG), device="cpu",
                         parallel=ParallelConfig(tp=1))
    assert engine.tp == 1 and engine.group is None and engine._lockstep is None
    assert engine.kv.k.shape[3] == cfg.num_key_value_heads
    assert not hasattr(engine.metrics(), "tp")


def _flat_tokens(cfg_t, source, prompts):
    flat = TorchEngine(cfg_t, source(0, 1, torch.device("cpu")),
                       EngineConfig(**ECFG), device="cpu")

    async def run():
        try:
            return await _collect(flat, prompts)
        finally:
            await flat.shutdown()

    return run()


@pytest.mark.parametrize("kind, drop", [("decode", "table"),
                                        ("embed", "lens")])
async def test_follower_failure_fails_the_step_and_recovers(
        kind, drop, tmp_path, monkeypatch):
    """A follower that cannot take a plan (its host arrays lack one) makes
    the leader's dispatch fail: a decode step's requests end in error, an
    embed request raises; the leader broadcasts recover and the group
    serves the next requests with the flat engine's tokens."""
    _, _, cfg_t, source = _setup("tiny_config", tmp_path)
    prompts = _prompts(cfg_t, n=2)[:2]
    want = await _flat_tokens(cfg_t, source, prompts)
    engine = _tp_engine(cfg_t, source)
    sent = []
    real = lockstep.plan_pack

    def faulty(desc):
        if desc["kind"] == kind and not sent:
            sent.append(desc)
            desc = {**desc, "arrays": {k: v for k, v in desc["arrays"].items()
                                       if k != drop}}
        return real(desc)

    monkeypatch.setattr(lockstep, "plan_pack", faulty)
    try:
        if kind == "embed":
            with pytest.raises(lockstep.FollowerError):
                await asyncio.wait_for(
                    engine.embed({"embed_token_ids": [[1, 2, 3]]}), 60)
            first = ["error"]
        else:
            first = await asyncio.wait_for(_collect(engine, prompts), 60)
        again = await asyncio.wait_for(_collect(engine, prompts), 60)
    finally:
        await engine.shutdown()
    assert sent and "error" in first
    assert again == want


async def test_follower_failing_midway_times_out_and_recovers(tmp_path,
                                                              monkeypatch):
    """A follower whose dispatch raises after its first model collectives
    (told to chain two decode blocks where the leader runs one, its second
    block's collectives have no partner and time out) refuses the
    leader's next plan; the leader fails the request and the group
    recovers (fresh pools, a fresh device group) and serves the flat
    engine's tokens again."""
    monkeypatch.setenv("DYN_TORCH_TP_TIMEOUT_S", "3")
    _, _, cfg_t, source = _setup("tiny_config", tmp_path)
    prompts = _prompts(cfg_t, n=1)[:1]
    want = await _flat_tokens(cfg_t, source, prompts)
    engine = _tp_engine(cfg_t, source)
    sent = []
    real = lockstep.plan_pack

    def faulty(desc):
        if desc["kind"] == "decode" and not sent:
            sent.append(desc)
            desc = {**desc, "chain_len": 2}
        return real(desc)

    monkeypatch.setattr(lockstep, "plan_pack", faulty)
    try:
        first = await asyncio.wait_for(_collect(engine, prompts), 90)
        again = await asyncio.wait_for(_collect(engine, prompts), 90)
    finally:
        await engine.shutdown()
    assert sent and first == ["error"]
    assert again == want


async def test_a_failed_build_leaves_the_group(tmp_path):
    """A rank that cannot build its shard (here every rank: the tree file
    is missing) fails the engine's construction; the leader stops its
    followers and leaves the group, so the process can build the next
    tp engine."""
    _, _, cfg_t, source = _setup("tiny_config", tmp_path)
    with pytest.raises(FileNotFoundError):
        _tp_engine(cfg_t, TreeShards(cfg_t, str(tmp_path / "missing.npz")))
    engine = _tp_engine(cfg_t, source)
    try:
        got = await asyncio.wait_for(_collect(engine, [[1, 2, 3]]), 60)
    finally:
        await engine.shutdown()
    assert len(got[0]) == 8

"""KV moves of a pipeline group of the port (`TorchEngine(parallel=
ParallelConfig(pp=2[, dp=2]))`, CPU gloo groups of 2 and 4 processes)
against the JAX package's single-device engine on the same seeded f32
weights (`tiny_config`, 2 layers: one a stage):

- the export of a pp 2 group holds every layer and every head (its
  stages' layers joined in stage order over the pp group), within 1e-5
  of JAX's export, and an import of it exports back byte for byte;
- a batch victim parks (its bytes: every layer) and resumes with its
  uncontended tokens, as on JAX's engine;
- KVBM offload, clear and onboard give the first run's tokens on pp 2
  and on a partitioned dp 2 x pp 2 group (JAX `tests/test_pp_engine.py:
  180-216`);
- a disagg prefill -> decode handoff between two partitioned dp 2 x pp 2
  groups (the prefill group shut down before the decode group starts:
  one group a process) equals a local run (JAX `:219-241`);
- host-tier blocks written at pp 2 onboard into a flat engine, and the
  other way round;
- the CUDA IPC lane turns a pipeline down (its pages take the host lane,
  ROADMAP 2.3b).

Every group runs inside one module-scoped fixture, one after the other;
the tests read its results.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxEngine
from dynamo_tpu.models import init_params as jax_init_params
from dynamo_tpu.models import tiny_config as jax_tiny_config
from dynamo_tpu.runtime import Context as JaxContext
from dynamo_tpu_torch import kvbm
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.models import params_from_jax, tiny_config
from dynamo_tpu_torch.parallel import ParallelConfig, TreeShards
from dynamo_tpu_torch.parallel.sharding import save_tree
from dynamo_tpu_torch.runtime import Context
from dynamo_tpu_torch.testing import host_threads

# one decode slot, so an interactive arrival can only be admitted by
# parking the batch victim (tests/test_torch_park.py's storm); 2-step
# decode blocks, so the ring hands tokens back to stage 0
ECFG = dict(page_size=8, num_pages=64, max_num_seqs=1, max_prefill_tokens=32,
            max_model_len=256, decode_steps=2)
# the partitioned groups (JAX `tests/test_pp_engine.py`'s engine)
PART = dict(page_size=8, num_pages=96, max_num_seqs=8, max_prefill_tokens=32,
            max_model_len=128, decode_steps=2, kv_partition=True)
VICTIM = [3, 1, 4, 1, 5, 9, 2, 6]
INTER = [8, 8, 8]
EXPORT_PROMPT = list(range(2, 39))  # 37 tokens: 4 full pages and a tail
TIER_PROMPT = list(range(1, 41))  # 5 full pages
CROSS_PROMPTS = {"pp2_to_flat": list(range(100, 140)),
                 "flat_to_pp2": list(range(50, 90))}
DISAGG_PROMPT = [(7 * j) % 101 + 1 for j in range(20)]


def req(tokens, max_tokens, priority=None):
    r = {"token_ids": tokens, "sampling_options": {"temperature": 0.0},
         "stop_conditions": {"max_tokens": max_tokens, "ignore_eos": True}}
    if priority:
        r["priority"] = priority
    return r


async def collect(engine, request):
    out = []
    async for d in engine.generate(request):
        assert d.get("finish_reason") != "error", d
        out.extend(d["token_ids"])
    return out


async def storm(engine):
    """The batch victim, and once it has streamed 2 tokens the
    interactive arrival: (victim tokens, interactive tokens)."""
    got, inter = [], None
    async for d in engine.generate(req(VICTIM, 12, priority="batch")):
        got.extend(d["token_ids"])
        if inter is None and len(got) >= 2:
            inter = asyncio.ensure_future(collect(engine, req(INTER, 4)))
    return got, await inter


async def drained(tiered):
    deadline = asyncio.get_running_loop().time() + 20
    while tiered.offload_backlog:
        assert asyncio.get_running_loop().time() < deadline, "no offload"
        await asyncio.sleep(0.02)


async def offload_and_onboard(engine, tiered):
    """(first tokens, tokens after the device cache is cleared, blocks
    onboarded then) of TIER_PROMPT."""
    first = await collect(engine, req(TIER_PROMPT, 4))
    await drained(tiered)
    assert len(tiered.host) >= 5
    engine.clear_kv_blocks()
    before = tiered.onboarded_blocks
    again = await collect(engine, req(TIER_PROMPT, 4))
    return first, again, tiered.onboarded_blocks - before


def _blob(kv):
    shape = kv["shape"]
    return [torch.frombuffer(bytearray(kv[n]), dtype=torch.float32).reshape(shape)
            for n in ("k", "v")]


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """(JAX params, the port's flat model, the groups' source)."""
    params = jax_init_params(jax_tiny_config(), jax.random.PRNGKey(0),
                             dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, params)
    path = str(tmp_path_factory.mktemp("pp_kv") / "tree.npz")
    save_tree(path, tree)
    cfg = tiny_config()
    return params, params_from_jax(cfg, tree, device="cpu"), TreeShards(cfg, path)


@pytest.fixture(scope="module")
def jax_flat(weights):
    """JAX's single-device engine: the export, the victim alone and in
    the storm, and the cold tokens of every other prompt."""
    params = weights[0]
    eng = JaxEngine(jax_tiny_config(), params, JaxEngineConfig(**ECFG),
                    eos_token_ids=[], kv_dtype=jnp.float32)
    out = {}

    async def run():
        try:
            r = await eng.prefill_remote(req(EXPORT_PROMPT, 1), JaxContext())
            out["export"] = r["kv"]
            out["alone"] = await collect(eng, req(VICTIM, 12))
            out["storm"] = await storm(eng)
            out["tier"] = await collect(eng, req(TIER_PROMPT, 4))
            out["disagg"] = await collect(eng, req(DISAGG_PROMPT, 8))
            for d, p in CROSS_PROMPTS.items():
                out[d] = await collect(eng, req(p, 6))
        finally:
            await eng.shutdown()

    asyncio.run(run())
    return out


def pp_group(source, ecfg=ECFG, dp=1, **kw):
    return TorchEngine(tiny_config(), source, EngineConfig(**ecfg),
                       eos_token_ids=[], parallel=ParallelConfig(dp=dp, pp=2),
                       devices=["cpu"] * (2 * dp), **kw)


@pytest.fixture(scope="module")
def moves(weights, tmp_path_factory):
    """Every group of the file, one after the other."""
    _, model, source = weights
    out = {}

    async def pp2():
        tiered = kvbm.TieredKvCache(kvbm.HostBlockPool(capacity_bytes=64 << 20))
        engine = pp_group(source, tiered=tiered)
        parked = []
        park = engine.scheduler.park_fn

        def spy_park(seq):
            ok = park(seq)
            entry = engine.parking._entries.get(seq.request_id)  # noqa: SLF001
            if ok and entry is not None:
                parked.append((entry.k.clone(), entry.v.clone()))
            return ok

        engine.scheduler.park_fn = spy_park
        try:
            r = await engine.prefill_remote(req(EXPORT_PROMPT, 1), Context())
            out["export"] = r["kv"]
            k, v = _blob(r["kv"])
            pages = await engine.alloc_pages(k.shape[1])
            await engine.import_page_chunk(pages, k, v)
            out["round_trip"] = (k, v, await engine.export_pages(pages))
            await engine.free_pages(pages)
            out["alone"] = await collect(engine, req(VICTIM, 12))
            out["storm"] = await storm(engine)
            out["parked"] = parked
            m = engine.metrics()
            out["storm_metrics"] = (m.preempted_total, m.resumed_total,
                                    len(engine.parking))
            out["kvbm_pp2"] = await offload_and_onboard(engine, tiered)
        finally:
            await engine.shutdown()

    async def partitioned_kvbm():
        tiered = kvbm.TieredKvCache(kvbm.HostBlockPool(capacity_bytes=64 << 20))
        engine = pp_group(source, PART, dp=2, tiered=tiered)
        try:
            out["kvbm_part"] = await offload_and_onboard(engine, tiered)
        finally:
            await engine.shutdown()

    async def disagg_prefill():
        engine = pp_group(source, PART, dp=2)
        try:
            out["blob"] = await engine.prefill_remote(req(DISAGG_PROMPT, 8))
        finally:
            await engine.shutdown()

    async def disagg_decode():
        engine = pp_group(source, PART, dp=2)
        blob = out["blob"]
        toks = []
        try:
            async for d in engine.generate_with_kv(req(DISAGG_PROMPT, 8),
                                                   blob["token_ids"][0],
                                                   blob["kv"]):
                assert d.get("finish_reason") != "error", d
                toks.extend(d["token_ids"])
            out["disagg"] = toks
        finally:
            await engine.shutdown()

    async def serve(make, tiered, direction):
        """The prompt of `direction` on a fresh engine: (tokens, blocks
        onboarded); its blocks stay in the tier."""
        engine = make(tiered=tiered)
        try:
            before = tiered.onboarded_blocks
            toks = await collect(engine, req(CROSS_PROMPTS[direction], 6))
            await drained(tiered)
            return toks, tiered.onboarded_blocks - before
        finally:
            await engine.shutdown()

    def flat(**kw):
        return TorchEngine(tiny_config(), model, EngineConfig(**ECFG),
                           eos_token_ids=[], device="cpu", **kw)

    def pp(**kw):
        return pp_group(source, **kw)

    with host_threads(1):  # the followers take the leader's thread count
        for step in (pp2, partitioned_kvbm, disagg_prefill, disagg_decode):
            asyncio.run(step())
        tiered = kvbm.TieredKvCache(kvbm.HostBlockPool(capacity_bytes=64 << 20))
        asyncio.run(serve(flat, tiered, "flat_to_pp2"))  # written flat
        out["flat_to_pp2"] = asyncio.run(serve(pp, tiered, "flat_to_pp2"))
        asyncio.run(serve(pp, tiered, "pp2_to_flat"))  # written at pp 2
        out["pp2_to_flat"] = asyncio.run(serve(flat, tiered, "pp2_to_flat"))
        out["tiered"] = tiered
    return out


def test_pp_export_holds_every_layer_as_jax_export(moves, jax_flat):
    got, want = moves["export"], jax_flat["export"]
    assert got["shape"] == want["shape"]
    assert got["shape"][0] == tiny_config().num_hidden_layers
    assert got["shape"][3] == tiny_config().num_key_value_heads
    for name in ("k", "v"):
        np.testing.assert_allclose(
            np.frombuffer(got[name], np.float32),
            np.frombuffer(want[name], np.float32), rtol=1e-5, atol=1e-5)


def test_pp_import_round_trip_is_byte_equal(moves):
    k, v, (k2, v2) = moves["round_trip"]
    assert torch.equal(k, k2) and torch.equal(v, v2)
    # every layer carries the prompt (no stage's half left zero)
    assert all(k[i].abs().sum() > 0 for i in range(k.shape[0]))


def test_pp_park_resume_token_identity(moves, jax_flat):
    got, inter = moves["storm"]
    assert got == moves["alone"] == jax_flat["alone"]
    assert (got, inter) == jax_flat["storm"]
    preempted, resumed, lot = moves["storm_metrics"]
    assert preempted == resumed >= 1 and lot == 0
    assert moves["parked"]
    for k, v in moves["parked"]:
        assert k.shape[0] == v.shape[0] == tiny_config().num_hidden_layers
        assert all(k[i].abs().sum() > 0 for i in range(k.shape[0]))


@pytest.mark.parametrize("arm", ["kvbm_pp2", "kvbm_part"])
def test_pp_kvbm_offload_onboard(moves, jax_flat, arm):
    first, again, onboarded = moves[arm]
    assert first == again == jax_flat["tier"]
    assert onboarded >= 4  # the last prompt block is never cache-hit


def test_pp_pooled_disagg_handoff(moves, jax_flat):
    assert "kv" in moves["blob"]
    assert moves["disagg"] == jax_flat["disagg"]


@pytest.mark.parametrize("direction", ["pp2_to_flat", "flat_to_pp2"])
def test_tier_blocks_onboard_across_pp(moves, jax_flat, direction):
    got, onboarded = moves[direction]
    assert got == jax_flat[direction]
    assert onboarded >= 4
    for h in moves["tiered"].host.summary():
        assert moves["tiered"].host.get(h).k.shape[0] == \
            tiny_config().num_hidden_layers


def test_ipc_lane_turns_a_pipeline_down():
    """ROADMAP 2.3b: neither a pipeline destination nor an entry from a
    pipeline source takes the CUDA IPC lane (an injected opener makes
    the lane otherwise usable on the CPU)."""
    from dynamo_tpu_torch.disagg.device_transfer import IpcLane

    dev = torch.device("cpu")
    assert IpcLane(dev, opener=lambda e, d: None).usable({"pp": 1})
    assert not IpcLane(dev, opener=lambda e, d: None).usable({"pp": 2})
    assert not IpcLane(dev, opener=lambda e, d: None, stages=2).usable({"pp": 1})

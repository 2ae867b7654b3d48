"""KV moves of a sequence-parallel group of the port (`TorchEngine(
parallel=ParallelConfig(sp=2[, dp=2]))`, CPU gloo groups of 2 and 4
processes) against the JAX package's single-device engine on the same
seeded f32 weights (`tiny_config`):

- the export of an sp 2 group (read on slot 0 of a replicated pool) is
  within 1e-5 of JAX's export, and an import of it (into every slot's
  pool) exports back byte for byte;
- a batch victim parks and resumes with its uncontended tokens, as on
  JAX's engine, on a replicated sp 2 pool and onto its own partition of a
  pool partitioned over the slots;
- KVBM offload, clear and onboard give the first run's tokens on sp 2;
- a disagg prefill -> decode handoff on the host lane between two
  partitioned dp 2 x sp 2 groups (the prefill group shut down before the
  decode group starts: one group a process) equals a local run;
- host-tier blocks written at sp 2 onboard into a flat engine, and the
  other way round;
- the CUDA IPC lane turns an sp group down (its pages take the host lane,
  ROADMAP 2.4b).

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
# parking the batch victim (tests/test_torch_park.py's storm); whole
# prompts, as sp requires
ECFG = dict(page_size=8, num_pages=64, max_num_seqs=1, max_prefill_tokens=64,
            max_model_len=64, decode_steps=2)
# the partitioned groups: no prefix cache under sp (JAX's rule)
PART = dict(page_size=8, num_pages=96, max_num_seqs=8, max_prefill_tokens=64,
            max_model_len=64, decode_steps=2, kv_partition=True,
            enable_prefix_caching=False)
# a partition per slot, two decode slots: an interactive anchor bigger
# than the victim takes the other partition, so the arrival's partition
# (the one with more free pages) is the victim's
PARK_PART = dict(PART, num_pages=16, max_num_seqs=2)
VICTIM = [3, 1, 4, 1, 5, 9, 2, 6]
INTER = [8, 8, 8]
ANCHOR = list(range(60, 100))  # 40 tokens: 5 pages and more
EXPORT_PROMPT = list(range(2, 39))  # 37 tokens: 4 full pages and a tail
TIER_PROMPT = list(range(1, 41))  # 5 full pages
CROSS_PROMPTS = {"sp2_to_flat": list(range(100, 140)),
                 "flat_to_sp2": list(range(50, 90))}
DISAGG_PROMPT = [(7 * j) % 101 + 1 for j in range(20)]


def req(tokens, max_tokens, priority=None):
    r = {"token_ids": tokens, "sampling_options": {"temperature": 0.0},
         "stop_conditions": {"max_tokens": max_tokens, "ignore_eos": True}}
    if priority:
        r["priority"] = priority
    return r


async def collect(engine, request, ctx=None):
    out = []
    async for d in engine.generate(request, *([ctx] if ctx else [])):
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


def _spy_parks(engine, into):
    """Record (partition, k, v) of every park, and the partition of every
    resume, into `into`."""
    park, resume = engine.scheduler.park_fn, engine.scheduler.resume_fn

    def spy_park(seq):
        ok = park(seq)
        entry = engine.parking._entries.get(seq.request_id)  # noqa: SLF001
        if ok and entry is not None:
            into.setdefault("parked", []).append(
                (seq.kv_rank, entry.k.clone(), entry.v.clone()))
        return ok

    def spy_resume(seq):
        resume(seq)
        into.setdefault("resumed", []).append(seq.kv_rank)

    engine.scheduler.park_fn = spy_park
    engine.scheduler.resume_fn = spy_resume


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
    path = str(tmp_path_factory.mktemp("sp_kv") / "tree.npz")
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


def sp_group(source, ecfg=ECFG, dp=1, **kw):
    return TorchEngine(tiny_config(), source, EngineConfig(**ecfg),
                       eos_token_ids=[], parallel=ParallelConfig(dp=dp, sp=2),
                       devices=["cpu"] * (2 * dp), **kw)


@pytest.fixture(scope="module")
def moves(weights):
    """Every group of the file, one after the other."""
    _, model, source = weights
    out = {}

    async def sp2():
        tiered = kvbm.TieredKvCache(kvbm.HostBlockPool(capacity_bytes=64 << 20))
        engine = sp_group(source, tiered=tiered)
        spied = {}
        _spy_parks(engine, spied)
        try:
            r = await engine.prefill_remote(req(EXPORT_PROMPT, 1), Context())
            out["export"] = r["kv"]
            k, v = _blob(r["kv"])
            pages = await engine.alloc_pages(k.shape[1])
            await engine.import_page_chunk(pages, k, v)
            out["round_trip"] = (k, v, await engine.export_pages(pages))
            out["slots"] = await engine._device_op(  # noqa: SLF001
                lambda: engine.rank_pages(pages))
            await engine.free_pages(pages)
            out["alone"] = await collect(engine, req(VICTIM, 12))
            out["storm"] = await storm(engine)
            out["spied"] = spied
            m = engine.metrics()
            out["storm_metrics"] = (m.preempted_total, m.resumed_total,
                                    len(engine.parking))
            first = await collect(engine, req(TIER_PROMPT, 4))
            await drained(tiered)
            engine.clear_kv_blocks()
            before = tiered.onboarded_blocks
            again = await collect(engine, req(TIER_PROMPT, 4))
            out["kvbm"] = (first, again, tiered.onboarded_blocks - before)
        finally:
            await engine.shutdown()

    async def partitioned_park():
        engine = sp_group(source, PARK_PART)
        spied = {}
        _spy_parks(engine, spied)
        try:
            out["part_alone"] = await collect(engine, req(VICTIM, 12))
            ctx = Context("anchor")
            first = asyncio.Event()

            async def anchor():
                toks = []
                async for d in engine.generate(req(ANCHOR, 20), ctx):
                    toks.extend(d["token_ids"])
                    first.set()
                return toks

            task = asyncio.ensure_future(anchor())
            await first.wait()
            out["part_storm"] = await storm(engine)
            ctx.stop_generating()
            await task
            out["part_spied"] = spied
        finally:
            await engine.shutdown()

    async def disagg_prefill():
        engine = sp_group(source, PART, dp=2)
        try:
            out["blob"] = await engine.prefill_remote(req(DISAGG_PROMPT, 8))
        finally:
            await engine.shutdown()

    async def disagg_decode():
        engine = sp_group(source, PART, dp=2)
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

    def sp(**kw):
        return sp_group(source, **kw)

    with host_threads(1):  # the followers take the leader's thread count
        for step in (sp2, partitioned_park, disagg_prefill, disagg_decode):
            asyncio.run(step())
        tiered = kvbm.TieredKvCache(kvbm.HostBlockPool(capacity_bytes=64 << 20))
        asyncio.run(serve(flat, tiered, "flat_to_sp2"))  # written flat
        out["flat_to_sp2"] = asyncio.run(serve(sp, tiered, "flat_to_sp2"))
        asyncio.run(serve(sp, tiered, "sp2_to_flat"))  # written at sp 2
        out["sp2_to_flat"] = asyncio.run(serve(flat, tiered, "sp2_to_flat"))
    return out


def test_sp_export_matches_jax_export(moves, jax_flat):
    got, want = moves["export"], jax_flat["export"]
    assert got["shape"] == want["shape"]
    for name in ("k", "v"):
        np.testing.assert_allclose(
            np.frombuffer(got[name], np.float32),
            np.frombuffer(want[name], np.float32), rtol=1e-5, atol=1e-5)


def test_sp_import_reaches_every_slot_byte_equal(moves):
    """The imported pages export back byte for byte, and both slots' pools
    hold them."""
    k, v, (k2, v2) = moves["round_trip"]
    assert torch.equal(k, k2) and torch.equal(v, v2)
    for sk, sv in moves["slots"]:
        assert torch.equal(sk, k) and torch.equal(sv, v)


def test_sp_park_resume_token_identity(moves, jax_flat):
    got, inter = moves["storm"]
    assert got == moves["alone"] == jax_flat["alone"]
    assert (got, inter) == jax_flat["storm"]
    preempted, resumed, lot = moves["storm_metrics"]
    assert preempted == resumed >= 1 and lot == 0
    assert moves["spied"]["parked"]


def test_sp_park_resumes_onto_its_partition(moves, jax_flat):
    """On a pool partitioned over the two slots, the victim parks from its
    partition and resumes onto it, with its uncontended tokens."""
    got, _ = moves["part_storm"]
    assert got == moves["part_alone"] == jax_flat["alone"]
    spied = moves["part_spied"]
    parts = [p for p, _, _ in spied["parked"]]
    assert parts and spied["resumed"] == parts
    for _, k, _ in spied["parked"]:
        assert k.shape[0] == tiny_config().num_hidden_layers
        assert k.abs().sum() > 0


def test_sp_kvbm_offload_onboard(moves, jax_flat):
    first, again, onboarded = moves["kvbm"]
    assert first == again == jax_flat["tier"]
    assert onboarded >= 4  # the last prompt block is never cache-hit


def test_sp_pooled_disagg_handoff(moves, jax_flat):
    assert "kv" in moves["blob"]
    assert moves["disagg"] == jax_flat["disagg"]


@pytest.mark.parametrize("direction", ["sp2_to_flat", "flat_to_sp2"])
def test_tier_blocks_onboard_across_sp(moves, jax_flat, direction):
    got, onboarded = moves[direction]
    assert got == jax_flat[direction]
    assert onboarded >= 4


def test_ipc_lane_turns_an_sp_group_down():
    """ROADMAP 2.4b: neither an sp destination nor an entry from an sp
    source takes the CUDA IPC lane (an injected opener makes the lane
    otherwise usable on the CPU)."""
    from dynamo_tpu_torch.disagg.device_transfer import IpcLane

    dev = torch.device("cpu")
    assert IpcLane(dev, opener=lambda e, d: None).usable({"sp": 1})
    assert not IpcLane(dev, opener=lambda e, d: None).usable({"sp": 2})
    assert not IpcLane(dev, opener=lambda e, d: None, sp=2).usable({"sp": 1})

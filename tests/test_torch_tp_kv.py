"""KV moves of a tensor-parallel `TorchEngine` (``parallel=ParallelConfig(
tp=2)``, a CPU gloo group of two processes): the ``kv_export`` /
``kv_import`` plans, parking and the KVBM tiers, against the JAX package
on the same seeded f32 weights (`params_from_jax` of one JAX tree).

- the tp 2 engine's export after a prefill holds every kv head, as
  `JaxEngine(parallel=ParallelConfig(tp=2))`'s (whose export gathers the
  sharded pool), within 1e-5; importing it into other pages and
  exporting those gives the same bytes;
- the storm of tests/test_torch_park.py on the tp 2 engine: the batch
  victim parks (its parked bytes full-head) for the interactive arrival
  and resumes to the tokens of its uncontended run on the same group and
  of the JAX tp 2 engine's storm;
- a host-tier and a disk-tier block written by the tp 2 engine onboard
  into a flat engine, and blocks a flat engine wrote onboard into the tp
  2 engine, every block full-head, with the cold run's tokens.

One tp group lives in a process at a time, so each scenario runs its
engines one after the other inside a module-scoped fixture; the tests
read its results.
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
from dynamo_tpu.parallel import ParallelConfig as JaxParallelConfig
from dynamo_tpu.runtime import Context as JaxContext
from dynamo_tpu_torch import kvbm
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.models import params_from_jax, tiny_config
from dynamo_tpu_torch.parallel import ParallelConfig, TreeShards
from dynamo_tpu_torch.parallel.sharding import save_tree
from dynamo_tpu_torch.runtime import Context

TP = 2
# one decode slot, so an interactive arrival can only be admitted by
# parking the batch victim (tests/test_torch_park.py's storm)
ECFG = dict(page_size=8, num_pages=64, max_num_seqs=1, max_prefill_tokens=32,
            max_model_len=256)
VICTIM = [3, 1, 4, 1, 5, 9, 2, 6]
INTER = [8, 8, 8]
EXPORT_PROMPT = list(range(2, 39))  # 37 tokens: 4 full pages and a tail
TIER_PROMPTS = {"tp2_to_flat": list(range(1, 41)),  # 5 full pages each
                "flat_to_tp2": list(range(50, 90))}
TIER_KINDS = {"host": dict(host_bytes=64 << 20, disk=False),
              # a host pool of ~1 block: blocks demote to the disk tier
              # and onboard from it
              "disk": dict(host_bytes=2 << 10, disk=True)}


def req(tokens, max_tokens, priority=None):
    r = {"token_ids": tokens, "sampling_options": {"temperature": 0.0},
         "stop_conditions": {"max_tokens": max_tokens, "ignore_eos": True}}
    if priority:
        r["priority"] = priority
    return r


async def collect(engine, request):
    out, reason = [], None
    async for d in engine.generate(request):
        out.extend(d["token_ids"])
        reason = d["finish_reason"]
    return out, reason


async def storm(engine):
    """The batch victim, and once it has streamed 2 tokens the
    interactive arrival: (victim tokens, interactive tokens, the order
    they finished in)."""
    got, order, inter = [], [], None

    async def run_inter():
        out = await collect(engine, req(INTER, 4))
        order.append("interactive")
        return out

    async for d in engine.generate(req(VICTIM, 12, priority="batch")):
        got.extend(d["token_ids"])
        if inter is None and len(got) >= 2:
            inter = asyncio.ensure_future(run_inter())
    order.append("victim")
    return got, (await inter)[0], order


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """(JAX params, the port's flat model, the tp group's source)."""
    params = jax_init_params(jax_tiny_config(), jax.random.PRNGKey(0),
                             dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, params)
    path = str(tmp_path_factory.mktemp("tp_kv") / "tree.npz")
    save_tree(path, tree)
    cfg = tiny_config()
    return params, params_from_jax(cfg, tree, device="cpu"), TreeShards(cfg, path)


def tp_engine(source, **kw):
    return TorchEngine(tiny_config(), source, EngineConfig(**ECFG),
                       eos_token_ids=[], parallel=ParallelConfig(tp=TP),
                       devices=["cpu"] * TP, **kw)


def flat_engine(model, **kw):
    return TorchEngine(tiny_config(), model, EngineConfig(**ECFG),
                       eos_token_ids=[], device="cpu", **kw)


def jax_tp_engine(params):
    return JaxEngine(jax_tiny_config(), params, JaxEngineConfig(**ECFG),
                     eos_token_ids=[], kv_dtype=jnp.float32,
                     devices=jax.devices()[:TP], parallel=JaxParallelConfig(tp=TP))


@pytest.fixture(scope="module")
def moves(weights):
    """One tp 2 group: its export, the import round trip, the victim
    alone, and the storm with its parked bytes; then the JAX tp 2
    engine's export and storm."""
    params, _, source = weights
    out = {}

    async def port():
        engine = tp_engine(source)
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
            shape = r["kv"]["shape"]
            k = torch.frombuffer(bytearray(r["kv"]["k"]),
                                 dtype=torch.float32).reshape(shape)
            v = torch.frombuffer(bytearray(r["kv"]["v"]),
                                 dtype=torch.float32).reshape(shape)
            pages = await engine.alloc_pages(shape[1])
            await engine.import_page_chunk(pages, k, v)
            back = await engine.export_pages(pages)
            await engine.free_pages(pages)
            out["round_trip"] = (k, v, back)
            out["alone"] = (await collect(engine, req(VICTIM, 12)))[0]
            out["storm"] = await storm(engine)
            out["parked"] = parked
            out["metrics"] = engine.metrics()
            out["lot"] = (len(engine.parking), engine.parking.pages_held)
        finally:
            await engine.shutdown()

    async def jax_side():
        engine = jax_tp_engine(params)
        try:
            r = await engine.prefill_remote(req(EXPORT_PROMPT, 1), JaxContext())
            out["jax_export"] = r["kv"]
            out["jax_storm"] = await storm(engine)
        finally:
            await engine.shutdown()

    asyncio.run(port())
    asyncio.run(jax_side())
    return out


def test_tp_export_holds_every_head_as_jax_tp_export(moves):
    got, want = moves["export"], moves["jax_export"]
    assert got["shape"] == want["shape"]
    assert got["shape"][3] == tiny_config().num_key_value_heads
    for name in ("k", "v"):
        np.testing.assert_allclose(
            np.frombuffer(got[name], np.float32),
            np.frombuffer(want[name], np.float32), rtol=1e-5, atol=1e-5)


def test_tp_import_round_trip_is_byte_equal(moves):
    k, v, (k2, v2) = moves["round_trip"]
    assert torch.equal(k, k2) and torch.equal(v, v2)
    assert k.abs().sum() > 0


def test_tp_park_resume_token_identity(moves):
    got, inter, order = moves["storm"]
    jgot, jinter, jorder = moves["jax_storm"]
    m = moves["metrics"]
    assert order == jorder == ["interactive", "victim"]
    assert got == moves["alone"] == jgot
    assert inter == jinter
    assert m.preempted_total == m.resumed_total >= 1
    assert moves["lot"] == (0, 0)


def test_tp_parked_bytes_hold_every_head(moves):
    assert moves["parked"]
    n_kv = tiny_config().num_key_value_heads
    for k, v in moves["parked"]:
        assert k.shape[3] == v.shape[3] == n_kv
        assert k.abs().sum() > 0 and v.abs().sum() > 0


def _tier(kind, tmp):
    spec = TIER_KINDS[kind]
    return kvbm.TieredKvCache(
        kvbm.HostBlockPool(capacity_bytes=spec["host_bytes"]),
        kvbm.DiskTier(str(tmp)) if spec["disk"] else None)


async def _drained(tiered):
    deadline = asyncio.get_running_loop().time() + 20
    while tiered.offload_backlog:
        assert asyncio.get_running_loop().time() < deadline, "no offload"
        await asyncio.sleep(0.02)


@pytest.fixture(scope="module")
def tier_runs(weights, tmp_path_factory):
    """Per tier kind: cold tokens of both prompts on a flat engine without
    tiers; a flat engine writes flat_to_tp2's blocks, the tp 2 engine
    onboards them and writes tp2_to_flat's, a flat engine onboards those.
    Returns {(kind, direction): (cold tokens, onboarded tokens, blocks
    onboarded, the tier's blocks)}."""
    _, model, source = weights
    out = {}

    async def cold():
        engine = flat_engine(model)
        try:
            return {d: (await collect(engine, req(p, 6)))[0]
                    for d, p in TIER_PROMPTS.items()}
        finally:
            await engine.shutdown()

    async def serve(make, tiered, direction):
        """Serve the prompt of `direction` on a fresh engine: returns
        (tokens, blocks onboarded) and leaves its blocks in the tier."""
        engine = make(tiered=tiered)
        try:
            before = tiered.onboarded_blocks
            toks = (await collect(engine, req(TIER_PROMPTS[direction], 6)))[0]
            await _drained(tiered)
            return toks, tiered.onboarded_blocks - before
        finally:
            await engine.shutdown()

    want = asyncio.run(cold())
    for kind in TIER_KINDS:
        tiered = _tier(kind, tmp_path_factory.mktemp(f"disk_{kind}"))
        flat = lambda **kw: flat_engine(model, **kw)  # noqa: E731
        tp = lambda **kw: tp_engine(source, **kw)  # noqa: E731
        asyncio.run(serve(flat, tiered, "flat_to_tp2"))       # written flat
        got = asyncio.run(serve(tp, tiered, "flat_to_tp2"))   # onboarded tp 2
        out[(kind, "flat_to_tp2")] = (want["flat_to_tp2"], *got, tiered)
        asyncio.run(serve(tp, tiered, "tp2_to_flat"))         # written tp 2
        got = asyncio.run(serve(flat, tiered, "tp2_to_flat"))  # onboarded flat
        out[(kind, "tp2_to_flat")] = (want["tp2_to_flat"], *got, tiered)
    return out


@pytest.mark.parametrize("direction", ["tp2_to_flat", "flat_to_tp2"])
@pytest.mark.parametrize("kind", sorted(TIER_KINDS))
def test_tier_blocks_onboard_across_tp(tier_runs, kind, direction):
    want, got, onboarded, tiered = tier_runs[(kind, direction)]
    assert got == want
    # the last prompt block is never cache-hit: 4 of the 5 onboard
    assert onboarded >= 4
    if kind == "disk":
        assert len(tiered.disk) >= 4
    n_kv = tiny_config().num_key_value_heads
    for h in tiered.host.summary():
        assert tiered.host.get(h).k.shape[2] == n_kv


async def test_a_refused_export_keeps_the_victim_running(weights, monkeypatch):
    """A follower that cannot take a ``kv_export`` plan (its page ids
    missing) answers not-ready before any collective: the park is
    declined, the victim runs on to its uncontended tokens, the group
    stays whole and serves the next request."""
    from dynamo_tpu_torch.engine import lockstep

    _, _, source = weights
    engine = tp_engine(source)
    real = lockstep.plan_pack
    sent = []

    def faulty(desc):
        if desc["kind"] == "kv_export":
            sent.append(desc["kind"])
            desc = {**desc, "arrays": {}}
        return real(desc)

    try:
        alone = (await collect(engine, req(VICTIM, 12)))[0]
        engine.clear_kv_blocks()
        monkeypatch.setattr(lockstep, "plan_pack", faulty)
        got, inter, order = await asyncio.wait_for(storm(engine), 120)
        monkeypatch.setattr(lockstep, "plan_pack", real)
        again = (await collect(engine, req(INTER, 4)))[0]
        m = engine.metrics()
    finally:
        await engine.shutdown()
    assert sent and m.preempted_total == 0
    assert order == ["victim", "interactive"]
    assert got == alone and again == inter

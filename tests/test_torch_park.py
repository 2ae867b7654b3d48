"""Preemption park/resume in the port (TorchEngine's `_park_seq`,
`_resume_parked`, `_unpark_seq` and `kvbm/park.py`) against the JAX
package's JaxEngine, on the CPU at f32 with the same tiny weights.

The storm of tests/test_engine.py `test_park_resume_token_identity`: one
decode slot, a batch-class victim mid-decode, an interactive arrival that
can only be admitted by parking the victim.  Both engines must park it,
finish the interactive request first, and resume the victim from its
parked bytes to exactly the tokens of an uncontended run.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxEngine
from dynamo_tpu.engine.scheduler import SamplingOptions as JaxSamplingOptions
from dynamo_tpu.engine.scheduler import Sequence as JaxSequence
from dynamo_tpu.kvbm import park as jax_park
from dynamo_tpu.models import init_params as jax_init_params
from dynamo_tpu.models import tiny_config as jax_tiny_config
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.engine.blocks import Variant
from dynamo_tpu_torch.engine.scheduler import SamplingOptions, Sequence
from dynamo_tpu_torch.kvbm import park as torch_park
from dynamo_tpu_torch.models import params_from_jax, tiny_config

ECFG = dict(page_size=8, num_pages=64, max_num_seqs=1, max_prefill_tokens=32,
            max_model_len=256)
CC = dict(decode_steps=4, decode_chain=2, decode_continuous=True)
VARIANTS = ("greedy", "seeded", "penalized", "continuous")


@pytest.fixture(scope="module")
def jax_params():
    return jax_init_params(jax_tiny_config(), jax.random.PRNGKey(0),
                           dtype=jnp.float32)


def torch_engine(jax_params, **over):
    cfg = tiny_config()
    model = params_from_jax(cfg, jax.tree.map(np.asarray, jax_params),
                            device="cpu")
    return TorchEngine(cfg, model, EngineConfig(**{**ECFG, **over}),
                       eos_token_ids=[], device="cpu")


def jax_engine(jax_params, **over):
    return JaxEngine(jax_tiny_config(), jax_params,
                     JaxEngineConfig(**{**ECFG, **over}), eos_token_ids=[],
                     kv_dtype=jnp.float32)


def req(tokens, max_tokens, temperature=0.0, priority=None, **so):
    r = {"token_ids": tokens,
         "sampling_options": {"temperature": temperature, **so},
         "stop_conditions": {"max_tokens": max_tokens, "ignore_eos": True}}
    if priority:
        r["priority"] = priority
    return r


def victim_req(variant):
    if variant in ("seeded", "penalized"):
        return req([3, 1, 4, 1, 5, 9, 2, 6], 12, temperature=0.9, seed=7,
                   priority="batch")
    return req([3, 1, 4, 1, 5, 9, 2, 6], 40 if variant == "continuous" else 12,
               priority="batch")


def inter_req(variant):
    if variant == "penalized":
        return req([8, 8, 8], 4, frequency_penalty=2.0)
    return req([8, 8, 8], 4)


def engine_over(variant):
    return CC if variant == "continuous" else {}


async def collect(engine, request):
    out, reason = [], None
    async for delta in engine.generate(request):
        out.extend(delta["token_ids"])
        reason = delta["finish_reason"]
    return out, reason


async def storm(engine, victim, inter, after=2):
    """Run `victim`; once it has streamed `after` tokens, send `inter`.
    Returns (victim tokens, victim finish reason, interactive result,
    the order the two finished in)."""
    got, reasons, order = [], [], []
    inter_task = None

    async def run_inter():
        out = await collect(engine, inter)
        order.append("interactive")
        return out

    async for delta in engine.generate(victim):
        got.extend(delta["token_ids"])
        reasons.append(delta["finish_reason"])
        if inter_task is None and len(got) >= after:
            inter_task = asyncio.ensure_future(run_inter())
    order.append("victim")
    assert inter_task is not None, "the victim never reached mid-decode"
    return got, reasons[-1], await inter_task, order


@pytest.mark.parametrize("variant", VARIANTS)
async def test_park_resume_token_identity(jax_params, variant):
    """Both engines park the batch victim for the interactive arrival,
    serve the interactive request first, and resume the victim to the
    uncontended run's tokens — greedy, seeded, beside a penalized
    interactive row, and in the continuous loop (where the arrival makes
    the running chain fall out with reason ``preempted``)."""
    over = engine_over(variant)
    oracle_eng = torch_engine(jax_params, **over)
    oracle, oracle_reason = await collect(oracle_eng, victim_req(variant))
    assert oracle_eng.metrics().preempted_total == 0
    await oracle_eng.shutdown()

    results = {}
    for name, make in (("torch", torch_engine), ("jax", jax_engine)):
        eng = make(jax_params, **over)
        # the continuous case sends the arrival once the victim's first
        # fused chain (prefill token + 2 blocks of 4) is past, so it lands
        # in the running continuous loop
        got, reason, inter, order = await storm(
            eng, victim_req(variant), inter_req(variant),
            after=12 if variant == "continuous" else 2)
        m = eng.metrics()
        await eng.shutdown()
        results[name] = got, inter
        assert order == ["interactive", "victim"], (name, order)
        assert reason == oracle_reason == "length", name
        assert m.preempted_total == m.resumed_total >= 1, (name, m)
        assert m.parked_seqs == 0 and m.parked_pages == 0, (name, m)
        assert len(eng.parking) == 0 and eng.parking.pages_held == 0
        if variant == "continuous":
            assert m.decode_cc_fallout_total.get("preempted", 0) >= 1, (
                name, m.decode_cc_fallout_total)
    assert results["torch"][0] == oracle, (results["torch"][0], oracle)
    assert results["jax"][0] == oracle, (results["jax"][0], oracle)
    assert results["torch"][1] == results["jax"][1]


async def test_park_resume_byte_exact_through_pool(jax_params):
    """The parked bytes are the victim's pages, the resumed pages hold the
    same bytes, the pool tensors are the same storage afterwards, and the
    port parks the KV JaxEngine parks (f32, within 1e-5)."""
    eng = torch_engine(jax_params)
    ptrs = (eng.kv.k.data_ptr(), eng.kv.v.data_ptr())
    ps = eng.cfg.page_size
    seen = {}
    park, resume = eng.scheduler.park_fn, eng.scheduler.resume_fn

    def spy_park(seq):
        n = -(-seq.num_computed // ps)
        seen["before"] = (eng.kv.k[:, seq.pages[:n]].clone(),
                          eng.kv.v[:, seq.pages[:n]].clone())
        ok = park(seq)
        entry = eng.parking._entries[seq.request_id]  # noqa: SLF001
        seen["parked"] = (entry.k.clone(), entry.v.clone(), seq.num_computed)
        return ok

    def spy_resume(seq):
        resume(seq)
        n = -(-seq.num_computed // ps)
        seen["after"] = (eng.kv.k[:, seq.pages[:n]].clone(),
                         eng.kv.v[:, seq.pages[:n]].clone(), list(seq.pages))

    eng.scheduler.park_fn, eng.scheduler.resume_fn = spy_park, spy_resume
    await storm(eng, victim_req("greedy"), inter_req("greedy"))
    await eng.shutdown()
    for i in range(2):
        assert torch.equal(seen["before"][i], seen["parked"][i])
        assert torch.equal(seen["before"][i], seen["after"][i])
    assert (eng.kv.k.data_ptr(), eng.kv.v.data_ptr()) == ptrs

    jeng = jax_engine(jax_params)
    jparked = {}
    jpark = jeng.parking.park

    def spy_jpark(entry):
        jparked["kv"] = (np.asarray(entry.k), np.asarray(entry.v),
                         entry.num_computed)
        return jpark(entry)

    jeng.parking.park = spy_jpark
    await storm(jeng, victim_req("greedy"), inter_req("greedy"))
    await jeng.shutdown()
    # the two storms may park at different tokens; a tail page's slots
    # past num_computed hold no KV
    n_tok = min(seen["parked"][2], jparked["kv"][2])

    def positions(a):
        a = np.asarray(a)
        return a.reshape(a.shape[0], -1, *a.shape[3:])[:, :n_tok]

    for i in range(2):
        np.testing.assert_allclose(positions(seen["parked"][i]),
                                   positions(jparked["kv"][i]),
                                   rtol=1e-5, atol=1e-5)


async def test_park_budget_keeps_victim_running(jax_params):
    """`park_max_pages` below the victim's footprint: neither engine
    parks, and the interactive request waits for the victim."""
    for make in (torch_engine, jax_engine):
        eng = make(jax_params, park_max_pages=1)
        got, _, inter, order = await storm(eng, victim_req("greedy"),
                                           inter_req("greedy"))
        m = eng.metrics()
        await eng.shutdown()
        assert order == ["victim", "interactive"]
        assert m.preempted_total == m.resumed_total == 0
        assert len(got) == 12 and len(inter[0]) == 4


@pytest.mark.parametrize("make", ["torch", "jax"])
async def test_failed_resume_errors_the_request(jax_params, make):
    """An import that fails at resume errors the victim's request: it is
    never recomputed, and the lot and the pool end balanced."""
    eng = (torch_engine if make == "torch" else jax_engine)(jax_params)

    def broken(*_a, **_k):
        raise RuntimeError("import failed")

    eng._import_dev = broken  # noqa: SLF001
    got, reason, inter, order = await storm(eng, victim_req("greedy"),
                                            inter_req("greedy"))
    m = eng.metrics()
    await eng.shutdown()
    assert reason == "error"
    assert 2 <= len(got) < 12  # what streamed before the park, no more
    assert len(inter[0]) == 4
    assert m.preempted_total == 1 and m.resumed_total == 0
    assert len(eng.parking) == 0
    if make == "torch":  # the port also frees the pages it failed to fill
        assert (eng.pool.free_pages + eng.pool.evictable_pages
                == eng.pool.num_pages - 1)


@pytest.mark.parametrize("make", ["torch", "jax"])
def test_parked_head_falls_out_of_intake_as_admit(jax_params, make):
    """A parked head never splices into a running chain: its resume is a
    KV import at plan time, so `_cc_intake` falls out with ``admit``; the
    same head unparked splices into the free slot."""
    if make == "torch":
        eng = torch_engine(jax_params, max_num_seqs=2, **CC)
        seq = Sequence("p", [1, 2, 3, 4], SamplingOptions(temperature=0.0))

        def intake(rows, seqs):
            return eng._cc_intake(rows, seqs, Variant(greedy=True))  # noqa: SLF001
    else:
        eng = jax_engine(jax_params, max_num_seqs=2, **CC)
        seq = JaxSequence("p", [1, 2, 3, 4], JaxSamplingOptions(temperature=0.0))

        def intake(rows, seqs):
            return eng._cc_intake(rows, seqs, False, False, True)  # noqa: SLF001
    seq.priority = "batch"
    seq.parked = True
    seq.num_computed = 4
    eng.scheduler.waiting.append(seq)
    rows, seqs = [None, None], []
    assert intake(rows, seqs) == ([], "admit")
    assert rows == [None, None] and list(eng.scheduler.waiting) == [seq]
    seq.parked = False
    seq.num_computed = 0
    assert intake(rows, seqs) == ([0], None)
    assert rows[0] is seq and seqs == [seq]


@pytest.mark.parametrize("mod", [torch_park, jax_park], ids=["torch", "jax"])
def test_parking_lot_budget_and_counters(mod):
    """The lot's budget, take/discard and counters, for both packages'
    classes."""
    lot = mod.ParkingLot(max_pages=5)

    def entry(rid, n):
        return mod.ParkedSeq(request_id=rid, k=None, v=None, n_pages=n,
                             num_computed=n * 8, kv_rank=0)

    assert lot.park(entry("a", 3))
    assert not lot.park(entry("a", 1))  # already parked
    assert not lot.can_park(3) and not lot.park(entry("b", 3))
    assert lot.park(entry("b", 2))
    assert lot.pages_held == 5 and len(lot) == 2
    assert lot.take("a").n_pages == 3 and lot.take("a") is None
    assert lot.discard("b") and not lot.discard("b")
    assert lot.pages_held == 0 and len(lot) == 0
    assert (lot.parked_total, lot.resumed_total, lot.discarded_total) == (2, 1, 1)

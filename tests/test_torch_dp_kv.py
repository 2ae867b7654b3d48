"""A partitioned pool (``EngineConfig(kv_partition=True)``) on a dp 2 group
of the port, and the KV moves on it, on CPU gloo groups, against the JAX
package on the same seeded f32 weights:

- ports of JAX's pooled tests (`tests/test_pooled_engine.py`): the
  capacity grows with the mesh, the prefix cache is per partition, mixed
  dispatches run on the partitioned pool with the unmixed and
  single-device tokens, decode buckets below ``max_num_seqs`` are
  refused, a disagg handoff between two partitioned groups (the import
  lands on the partition that admits the request), and the pool's single
  ``cleared`` event;
- `ShardedPagePool` and the scheduler over it held to JAX's op for op on
  seeded operations;
- a batch victim on partition 1 parks and resumes there, a prompt's
  blocks onboard from the host tier into the admitting partition, each
  with JAX's single-device tokens (JAX's own partitioned KVBM test is
  marked slow: `tests/test_kvbm.py:562-566`);
- the MoE model (experts over tp) on a partitioned dp 2 x tp 2 group
  with the greedy tokens of JAX's engine on the same mesh;
- ``worker --dp 2 --tp 2 --kv-partition --device cpu`` builds the group
  and answers a request, its capacity reported as one pool.

One group lives in a process at a time: each scenario's engines run one
after the other inside a module-scoped fixture; the tests read its
results.
"""

import asyncio
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxEngine
from dynamo_tpu.engine.page_pool import ShardedPagePool as JaxShardedPagePool
from dynamo_tpu.engine.scheduler import Scheduler as JaxScheduler
from dynamo_tpu.engine.scheduler import SamplingOptions as JaxOpts
from dynamo_tpu.engine.scheduler import Sequence as JaxSequence
from dynamo_tpu.models import config as jcfg
from dynamo_tpu.models import llama as jl
from dynamo_tpu.parallel import ParallelConfig as JaxParallelConfig
from dynamo_tpu_torch import kvbm
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.engine.page_pool import ShardedPagePool
from dynamo_tpu_torch.engine.scheduler import SamplingOptions, Scheduler, Sequence
from dynamo_tpu_torch.models import config as tcfg
from dynamo_tpu_torch.models import params_from_jax
from dynamo_tpu_torch.parallel import ParallelConfig, TreeShards
from dynamo_tpu_torch.parallel.sharding import save_tree
from dynamo_tpu_torch.testing import host_threads

DP = 2
# JAX's pooled tests' engine (`tests/test_pooled_engine.py` make_engine)
BASE = dict(page_size=8, num_pages=64, max_num_seqs=8, max_prefill_tokens=64,
            max_model_len=128)
MIX = dict(max_prefill_tokens=16, max_model_len=256, decode_steps=2,
           num_pages=128)
MIX_PROMPTS = [
    [1, 2, 3],
    [(7 * j) % 101 + 1 for j in range(60)],
    [(3 * j) % 97 + 1 for j in range(45)],
    [9, 8, 7, 6, 5],
]
DISAGG_PROMPT = [(7 * j) % 101 + 1 for j in range(20)]
PREFIX_PROMPT = [(11 * j) % 89 + 1 for j in range(32)]
# the storm: two decode slots; the anchor (interactive, 40 tokens) holds
# partition 0's pages, so the batch victim admits onto partition 1 and
# the interactive arrival parks it there
MOVES = dict(page_size=8, num_pages=64, max_num_seqs=2, max_prefill_tokens=64,
             max_model_len=256)
ANCHOR = [(5 * j) % 90 + 2 for j in range(40)]
VICTIM = [3, 1, 4, 1, 5, 9, 2, 6]
INTER = [8, 8, 8]
TIER_PROMPT = list(range(1, 41))  # 5 full pages


def req(tokens, max_tokens=6, priority=None, **so):
    r = {"token_ids": tokens,
         "sampling_options": {"temperature": 0.0, **so},
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


def pooled(source, cfg=None, **over):
    return TorchEngine(cfg or tcfg.tiny_config(), source,
                       EngineConfig(**{**BASE, **over}, kv_partition=True),
                       eos_token_ids=[], parallel=ParallelConfig(dp=DP),
                       devices=["cpu"] * DP)


def _record_pages(scheduler, into):
    real = scheduler._finish

    def spy(seq, reason):
        into.setdefault(tuple(seq.prompt), []).append(list(seq.pages))
        return real(seq, reason)

    scheduler._finish = spy


def _spy_plans(engine):
    plans = []
    real = engine.scheduler.schedule

    def spy():
        plan = real()
        plans.append(plan.kind)
        return plan

    engine.scheduler.schedule = spy
    return plans


async def _staggered(engine, prompts, max_tokens=10, stagger=0.05):
    async def one(i, p):
        await asyncio.sleep(stagger * i)
        return await collect(engine, req(p, max_tokens=max_tokens))

    return await asyncio.gather(*[one(i, p) for i, p in enumerate(prompts)])


async def _one_after_another(engine, requests):
    """Start each request once the previous one has its first token."""
    tasks = []
    for r in requests:
        first = asyncio.Event()

        async def one(r=r, first=first):
            out = []
            async for d in engine.generate(r):
                assert d.get("finish_reason") != "error", d
                out.extend(d["token_ids"])
                first.set()
            return out

        tasks.append(asyncio.ensure_future(one()))
        await first.wait()
    return await asyncio.gather(*tasks)


async def _anchored(engine, body):
    """Run `body()` while the anchor request holds partition 0's pages
    (stopped once body is done); returns (body's result, the anchor's
    finish reason: "cancelled" when it outlasted body)."""
    from dynamo_tpu_torch.runtime import Context

    holding, ctx = asyncio.Event(), Context()

    async def anchor():
        reason = None
        async for d in engine.generate(req(ANCHOR, 120, priority="interactive"),
                                       ctx):
            holding.set()
            reason = d["finish_reason"]
        return reason

    task = asyncio.ensure_future(anchor())
    await holding.wait()
    try:
        out = await body()
    finally:
        ctx.stop_generating()
    return out, await task


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """{arm: (JAX config, JAX params, the port's flat model, the groups'
    source)}, each drawn once."""
    out = {}
    for arm, factory in (("dense", "tiny_config"), ("moe", "tiny_moe_config")):
        cfg_j, cfg_t = getattr(jcfg, factory)(), getattr(tcfg, factory)()
        params = jl.init_params(cfg_j, jax.random.PRNGKey(0), dtype=jnp.float32)
        tree = jax.tree.map(np.asarray, params)
        path = str(tmp_path_factory.mktemp(arm) / "tree.npz")
        save_tree(path, tree)
        out[arm] = (cfg_j, params, params_from_jax(cfg_t, tree, device="cpu"),
                    TreeShards(cfg_t, path))
    return out


@pytest.fixture(scope="module")
def jax_single(weights):
    """JAX's single-device greedy tokens of every request the scenarios
    hold to it."""
    cfg_j, params, _, _ = weights["dense"]
    eng = JaxEngine(cfg_j, params, JaxEngineConfig(**{**BASE, **MIX}),
                    eos_token_ids=[], kv_dtype=jnp.float32)
    wanted = {"victim": req(VICTIM, 12), "inter": req(INTER, 4),
              "tier": req(TIER_PROMPT, 6), "disagg": req(DISAGG_PROMPT, 8),
              **{f"mix{i}": req(p, 10) for i, p in enumerate(MIX_PROMPTS)}}

    async def run():
        try:
            return {k: await collect(eng, r) for k, r in wanted.items()}
        finally:
            await eng.shutdown()

    return asyncio.run(run())


@pytest.fixture(scope="module")
def scenarios(weights):
    """Every partitioned group of the file, one after the other."""
    _, _, flat_model, source = weights["dense"]
    out = {}

    async def capacity():
        # per-partition pool: 16 pages of 8 tokens (15 usable); 6
        # sequences of 48 tokens need 36 pages: both partitions
        eng = pooled(source, num_pages=16, max_model_len=64, watermark=0.0)
        prompts = [[(5 * j + i) % 90 + 1 for j in range(40)] for i in range(6)]
        held = []
        real = eng.scheduler.schedule

        def spy():
            plan = real()
            held.append(eng.pool.ranks * 15 - eng.pool.available_pages)
            return plan

        eng.scheduler.schedule = spy
        try:
            out["capacity_total"] = eng.metrics().kv_total_pages
            # JAX's wave: every prompt at once (admission ties go to
            # partition 0, so they queue there)
            out["capacity"] = await asyncio.gather(
                *[collect(eng, req(p, 8)) for p in prompts])
            # then a wave whose prompts arrive one after another's first
            # token: each admits onto the partition with more free pages
            held.clear()
            out["capacity_stagger"] = await _one_after_another(
                eng, [req(p, 8) for p in prompts])
            out["capacity_peak"] = max(held)
        finally:
            await eng.shutdown()

    async def prefix_and_prefill():
        eng = pooled(source)
        try:
            first = await collect(eng, req(PREFIX_PROMPT))
            second = await collect(eng, req(PREFIX_PROMPT))
            out["prefix"] = (first, second, eng.metrics().prefix_cached_tokens_total)
            # the prefill side of the handoff: one partition's pages
            blob = await eng.prefill_remote(req(DISAGG_PROMPT, 8))
            out["blob"] = blob
        finally:
            await eng.shutdown()

    async def decode_side():
        eng = pooled(source, max_model_len=256, max_num_seqs=2)
        pages = {}
        _record_pages(eng.scheduler, pages)
        blob = out["blob"]

        async def adopt():
            toks = []
            async for d in eng.generate_with_kv(req(DISAGG_PROMPT, 8),
                                                blob["token_ids"][0], blob["kv"]):
                assert d.get("finish_reason") != "error", d
                toks.extend(d["token_ids"])
            return toks

        try:
            out["disagg"], out["disagg_anchor"] = await _anchored(eng, adopt)
            out["disagg_pages"] = pages[tuple(DISAGG_PROMPT)]
        finally:
            await eng.shutdown()

    async def mixed():
        res = {}
        for name, over in (("mixed", {}), ("unmixed", {"mixed_prefill_tokens": 0})):
            eng = pooled(source, **{**MIX, **over})
            plans = _spy_plans(eng)
            try:
                res[name] = (await _staggered(eng, MIX_PROMPTS), plans,
                             eng.cfg.mixed_prefill_tokens)
            finally:
                await eng.shutdown()
        flat = TorchEngine(tcfg.tiny_config(), flat_model,
                           EngineConfig(**{**BASE, **MIX}), eos_token_ids=[],
                           device="cpu")
        try:
            res["flat"] = await _staggered(flat, MIX_PROMPTS)
        finally:
            await flat.shutdown()
        out["mix"] = res

    async def moves():
        tiered = kvbm.TieredKvCache(kvbm.HostBlockPool(capacity_bytes=64 << 20))
        eng = TorchEngine(tcfg.tiny_config(), source,
                          EngineConfig(**MOVES, kv_partition=True),
                          eos_token_ids=[], parallel=ParallelConfig(dp=DP),
                          devices=["cpu"] * DP, tiered=tiered)
        pages = {}
        _record_pages(eng.scheduler, pages)
        parked = []
        park = eng.scheduler.park_fn

        def spy_park(seq):
            ok = park(seq)
            if ok:
                parked.append((seq.kv_rank, eng.parking._entries[  # noqa: SLF001
                    seq.request_id].n_pages))
            return ok

        eng.scheduler.park_fn = spy_park

        async def storm():
            got, inter = [], None
            async for d in eng.generate(req(VICTIM, 12, priority="batch")):
                got.extend(d["token_ids"])
                if inter is None and len(got) >= 2:
                    inter = asyncio.ensure_future(collect(
                        eng, req(INTER, 4, priority="interactive")))
            return got, await inter

        async def tier():
            first = await collect(eng, req(TIER_PROMPT, 6))
            deadline = asyncio.get_running_loop().time() + 20
            while tiered.offload_backlog:
                assert asyncio.get_running_loop().time() < deadline
                await asyncio.sleep(0.02)
            eng.clear_kv_blocks()
            before = tiered.onboarded_blocks
            again = await collect(eng, req(TIER_PROMPT, 6))
            return first, again, tiered.onboarded_blocks - before

        try:
            out["storm"], out["storm_anchor"] = await _anchored(eng, storm)
            out["parked"] = parked
            out["tier"], out["tier_anchor"] = await _anchored(eng, tier)
            out["moves_pages"] = pages
            m = eng.metrics()
            out["moves_metrics"] = (m.preempted_total, m.resumed_total,
                                    len(eng.parking))
        finally:
            await eng.shutdown()

    # one thread a rank (the followers take the leader's count)
    with host_threads(1):
        for step in (capacity, prefix_and_prefill, decode_side, mixed, moves):
            asyncio.run(step())
    return out


def test_capacity_scales_with_mesh(scenarios):
    """(`tests/test_pooled_engine.py:106`) Sequences whose pages exceed
    one partition's pool fit across the partitions, and the engine
    reports the summed capacity."""
    assert scenarios["capacity_total"] == DP * 15
    assert all(len(o) == 8 for o in scenarios["capacity"])
    assert 6 * (48 // 8) > 15, "the load must overflow one partition"
    # the staggered wave held more pages at once than one partition has
    assert scenarios["capacity_stagger"] == scenarios["capacity"]
    assert scenarios["capacity_peak"] > 15


def test_pooled_prefix_cache_reuse(scenarios):
    """(`:128`) A repeated prompt admits onto the partition holding its
    blocks and reuses them."""
    first, second, cached = scenarios["prefix"]
    assert first == second
    assert cached >= 3 * 8


def test_pooled_mixed_scheduling_matches_unmixed(scenarios, jax_single):
    """(`:177`) Mixed dispatches run on the partitioned pool, with the
    tokens of the unmixed group, of the flat engine and of JAX's
    single-device engine."""
    mix = scenarios["mix"]
    got, plans, mixed_tokens = mix["mixed"]
    want, _, unmixed_tokens = mix["unmixed"]
    assert mixed_tokens > 0 and unmixed_tokens == 0
    assert "mixed" in plans, set(plans)
    assert got == want == mix["flat"]
    assert got == [jax_single[f"mix{i}"] for i in range(len(MIX_PROMPTS))]


def test_pooled_rejects_clamping_decode_buckets():
    """(`:265`) Decode buckets whose largest is below max_num_seqs are
    refused before a follower is spawned (JAX's message)."""
    cfg = tcfg.tiny_config()
    from dynamo_tpu_torch.parallel import SeededShards

    with pytest.raises(ValueError, match="decode_batch_buckets"):
        TorchEngine(cfg, SeededShards(cfg, 0, "float32"),
                    EngineConfig(**BASE, kv_partition=True,
                                 decode_batch_buckets=[1, 2, 4]),
                    parallel=ParallelConfig(dp=DP), devices=["cpu"] * DP)


def test_pooled_disagg_handoff(scenarios, jax_single):
    """(`:295`) The prefill group exports one partition's pages, the
    decode group imports them into the partition that admits the request
    (partition 1: the anchor holds partition 0) and continues with the
    single-device tokens."""
    assert "kv" in scenarios["blob"]
    assert scenarios["disagg"] == jax_single["disagg"]
    (pages,) = scenarios["disagg_pages"]
    assert {p // BASE["num_pages"] for p in pages} == {1}
    assert scenarios["disagg_anchor"] == "cancelled"  # it held partition 0


def test_pooled_park_resume_on_the_victims_partition(scenarios, jax_single):
    """The batch victim, admitted onto partition 1, parks there for the
    interactive arrival and resumes there, with its uncontended
    single-device tokens."""
    got, inter = scenarios["storm"]
    assert got == jax_single["victim"] and inter == jax_single["inter"]
    assert scenarios["parked"] and all(r == 1 for r, _ in scenarios["parked"])
    for pages in scenarios["moves_pages"][tuple(VICTIM)]:
        assert {p // MOVES["num_pages"] for p in pages} == {1}
    preempted, resumed, lot = scenarios["moves_metrics"]
    assert preempted == resumed >= 1 and lot == 0
    assert scenarios["storm_anchor"] == "cancelled"  # it held partition 0


def test_pooled_kvbm_onboard_into_the_admitting_partition(scenarios,
                                                          jax_single):
    """A prompt's blocks offloaded to the host tier onboard (after the
    device cache is cleared) into the partition that admits it again
    (partition 1: the anchor holds partition 0), with the cold
    single-device tokens."""
    first, again, onboarded = scenarios["tier"]
    assert first == again == jax_single["tier"]
    assert onboarded >= 4  # the last prompt block is never cache-hit
    # the anchor held partition 0 throughout: both runs admitted onto 1
    assert scenarios["tier_anchor"] == "cancelled"
    for pages in scenarios["moves_pages"][tuple(TIER_PROMPT)]:
        assert {p // MOVES["num_pages"] for p in pages} == {1}


def test_moe_on_a_partitioned_dp_tp_group_matches_jax(weights):
    """The MoE model, its experts over tp, on a partitioned dp 2 x tp 2
    group: JAX's greedy tokens on the same mesh."""
    cfg_j, params, _, source = weights["moe"]
    prompts = [[(i * 13 + j) % 256 for j in range(5 + 3 * i)] for i in range(3)]
    ecfg = dict(page_size=8, num_pages=64, max_num_seqs=8,
                max_prefill_tokens=32, max_model_len=128, kv_partition=True)
    jeng = JaxEngine(cfg_j, params, JaxEngineConfig(**ecfg), eos_token_ids=[],
                     kv_dtype=jnp.float32, devices=jax.devices()[:4],
                     parallel=JaxParallelConfig(dp=DP, tp=2))

    async def run(eng):
        try:
            return await asyncio.gather(*[collect(eng, req(p, 6))
                                          for p in prompts])
        finally:
            await eng.shutdown()

    want = asyncio.run(run(jeng))
    with host_threads(1):
        eng = TorchEngine(tcfg.tiny_moe_config(), source, EngineConfig(**ecfg),
                          eos_token_ids=[], parallel=ParallelConfig(dp=DP, tp=2),
                          devices=["cpu"] * 4)
        assert asyncio.run(run(eng)) == want


# -- the pool and the scheduler over it, op for op ------------------------------ #


def test_sharded_pool_single_cleared_event():
    """(`:275`) clear_cache emits ONE `cleared` event, after every
    partition has cleared."""
    events = []
    pool = ShardedPagePool(4, 16, 8, event_sink=events.append)
    for r in range(4):
        pages = pool.allocate_on(r, 2)
        for i, p in enumerate(pages):
            pool.commit(p, 1000 * r + i, None)
        pool.free(pages)
    events.clear()
    pool.clear_cache()
    cleared = [e for e in events if e.kind == "cleared"]
    assert len(cleared) == 1
    assert events[-1].kind == "cleared"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sharded_pool_matches_jax_op_for_op(seed):
    """Seeded allocate / commit / free / lookup / evict / clear sequences
    on the port's `ShardedPagePool` and JAX's give the same pages, the
    same answers and the same deduplicated events."""
    rng = random.Random(seed)
    ev_t, ev_j = [], []
    ours = ShardedPagePool(3, 12, 4, event_sink=ev_t.append)
    theirs = JaxShardedPagePool(3, 12, 4, event_sink=ev_j.append)
    held = []
    hashes = list(range(100, 130))
    for _ in range(300):
        op = rng.choice(["alloc", "alloc_any", "commit", "free", "lookup",
                         "best", "clear", "peek"])
        if op in ("alloc", "alloc_any"):
            r, n = rng.randrange(3), rng.randint(1, 3)
            got = []
            for pool in (ours, theirs):
                try:
                    got.append(pool.allocate_on(r, n) if op == "alloc"
                               else pool.allocate(n))
                except Exception as e:  # noqa: BLE001 — both must refuse
                    got.append((type(e).__name__, str(e)))
            assert got[0] == got[1]
            if isinstance(got[0], list):
                held += got[0]
        elif op == "commit" and held:
            p = rng.choice(held)
            h = rng.choice(hashes)
            assert ours.commit(p, h, None) == theirs.commit(p, h, None)
        elif op == "free" and held:
            pages = [held.pop(rng.randrange(len(held)))
                     for _ in range(min(len(held), rng.randint(1, 3)))]
            ours.free(pages)
            theirs.free(pages)
        elif op == "lookup":
            r, chain = rng.randrange(3), rng.sample(hashes, 3)
            a, b = ours.lookup_on(r, chain), theirs.lookup_on(r, chain)
            assert a == b
            held += a
        elif op == "best":
            chain = rng.sample(hashes, 2)
            assert ours.best_rank(chain) == theirs.best_rank(chain)
        elif op == "peek":
            chain = rng.sample(hashes, 2)
            assert ours.peek(chain) == theirs.peek(chain)
        elif op == "clear":
            assert ours.clear_cache() == theirs.clear_cache()
        assert (ours.available_pages, ours.free_pages, ours.usage_max_rank()) \
            == (theirs.available_pages, theirs.free_pages,
                theirs.usage_max_rank())
    assert [(e.kind, e.block_hashes) for e in ev_t] \
        == [(e.kind, e.block_hashes) for e in ev_j]


def _drive(sched, seq_cls, opts_cls, prompts, steps=60):
    """Add the prompts, then schedule and account steps as an engine does
    (chunks computed, one token a decode row); returns every step's plan
    kind and each sequence's (partition, pages) as it stands."""
    seqs = []
    for i, p in enumerate(prompts):
        s = seq_cls(f"r{i}", p, opts_cls(temperature=0.0, max_tokens=6,
                                         ignore_eos=True))
        sched.add(s)
        seqs.append(s)
    trace = []
    for step in range(steps):
        plan = sched.schedule()
        trace.append((plan.kind, [(s.request_id, s.kv_rank, list(s.pages))
                                  for s in seqs]))
        if plan.kind == "idle":
            break
        for it in plan.prefill or []:
            it.seq.num_computed += it.chunk_len
            sched.commit_full_pages(it.seq)
            if it.samples:
                it.seq.output_tokens.append(step)
        for s in plan.decode or []:
            if s.status != "running":
                continue
            s.num_computed += 1
            sched.commit_full_pages(s)
            s.output_tokens.append(step)
            if len(s.output_tokens) >= s.opts.max_tokens:
                sched.finish(s, "length")
    return trace


def test_scheduler_over_a_sharded_pool_matches_jax():
    """The copied scheduler over a `ShardedPagePool` makes JAX's choices:
    the same plans, partitions and pages for seeded prompts (the
    partition choice, `scheduler.py:300-360`, and the rank-aware page
    growth)."""
    rng = random.Random(7)
    prompts = [[rng.randrange(1, 200) for _ in range(rng.randint(3, 40))]
               for _ in range(7)]
    prompts.append(list(prompts[0]))  # a repeated prompt steers to its rank
    over = dict(page_size=4, num_pages=24, max_num_seqs=4,
                max_prefill_tokens=16, max_model_len=64)
    ours = Scheduler(EngineConfig(**over), ShardedPagePool(2, 24, 4))
    theirs = JaxScheduler(JaxEngineConfig(**over),
                          JaxShardedPagePool(2, 24, 4))
    a = _drive(ours, Sequence, SamplingOptions, prompts)
    b = _drive(theirs, JaxSequence, JaxOpts, prompts)
    assert a == b
    assert {r for _, rows in a for _, r, _ in rows} == {0, 1}


# -- the worker ------------------------------------------------------------------ #


def test_worker_serves_a_partitioned_dp_tp_group(tmp_path):
    """`worker --dp 2 --tp 2 --kv-partition --device cpu` builds a group of
    4 processes and answers a request; `/metrics` reports the partitions
    as one pool.  The model is the golden tiny Llama checkpoint (its
    vocabulary of 256 splits over tp 2; the ``tiny`` model's 261 does
    not), with a test tokenizer beside it."""
    import os
    import shutil

    from dynamo_tpu_torch.frontend.metrics import engine_stats_exposition
    from dynamo_tpu_torch.worker.__main__ import build_engine, build_parser, check_role

    fix = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
    for name in ("config.json", "model.safetensors"):
        shutil.copy(os.path.join(fix, "golden_llama", name), tmp_path / name)
    shutil.copy(os.path.join(fix, "torch_golden_llama_hd64", "tokenizer.json"),
                tmp_path / "tokenizer.json")
    args = build_parser().parse_args([
        "--control", "x:1", "--model", str(tmp_path), "--dtype", "float32",
        "--dp", "2", "--tp", "2", "--kv-partition", "--device", "cpu",
        "--num-pages", "32", "--max-model-len", "128"])
    check_role(args)

    async def run():
        try:
            return (await collect(engine, req([5, 6, 7, 8], 4)),
                    engine.metrics())
        finally:
            await engine.shutdown()

    with host_threads(1):
        engine, _ = build_engine(args)
        toks, m = asyncio.run(run())
    assert len(toks) == 4
    assert (m.dp, m.tp, m.kv_partition, m.kv_total_pages) == (2, 2, True, 62)
    text = engine_stats_exposition(vars(m), "dynamo", "backend").decode()
    total = [ln for ln in text.splitlines()
             if "kv_total_pages" in ln and not ln.startswith("#")]
    assert total and total[0].split()[-1] in ("62", "62.0")

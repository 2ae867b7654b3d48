"""The port's KV router (dynamo_tpu_torch.router) against the JAX
package's (dynamo_tpu.router), on the CPU.

- The host cases of tests/test_kv_router.py run over both packages'
  classes (the pure-Python index on both sides): the same inputs must give
  the same overlaps, snapshots, TTL expiries, scheduling decisions
  (temperature 0 and seeded), load tracking and worker keys.
- The port's block hashes equal the JAX package's, salted or not, through
  the JAX Python hasher and through its native hasher (built here from
  ``native/block_hash.cpp``).
- The wire is shared: the port's KV-event, metrics and snapshot payloads
  are the JAX package's bytes.
- End to end: two tiny TorchEngine workers (weights from
  ``params_from_jax``) behind the port's frontend in ``kv`` mode route a
  returning prefix to its holder and answer 503 when every worker is
  busy; the standalone ``python -m dynamo_tpu_torch.router`` service
  chooses the holder too.
- Across packages: a JAX frontend in ``kv`` mode over the JAX control
  plane routes by overlap to port workers, and the port's router over
  the port's control plane routes by overlap to JAX mock workers.
"""

import asyncio
import ctypes
import os
import random
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dynamo_tpu import tokens as jax_tokens
from dynamo_tpu.llm import ModelDeploymentCard as JaxCard
from dynamo_tpu.mocker import MockEngine, MockEngineArgs
from dynamo_tpu.models import init_params as jax_init_params
from dynamo_tpu.models import tiny_config as jax_tiny_config
from dynamo_tpu.router import indexer as jax_indexer
from dynamo_tpu.router import kv_router as jax_kv_router
from dynamo_tpu.router import publisher as jax_publisher
from dynamo_tpu.router import scheduler as jax_scheduler
from dynamo_tpu.router import sequence as jax_sequence
from dynamo_tpu.router import worker_key as jax_worker_key
from dynamo_tpu.runtime import DistributedRuntime as JaxRuntime
from dynamo_tpu.testing import tiny_tokenizer as jax_tiny_tokenizer
from dynamo_tpu.worker import serve_engine as jax_serve_engine
from dynamo_tpu_torch import tokens as torch_tokens
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.llm import ModelDeploymentCard
from dynamo_tpu_torch.models import params_from_jax, tiny_config
from dynamo_tpu_torch.router import indexer as torch_indexer
from dynamo_tpu_torch.router import kv_router as torch_kv_router
from dynamo_tpu_torch.router import publisher as torch_publisher
from dynamo_tpu_torch.router import scheduler as torch_scheduler
from dynamo_tpu_torch.router import sequence as torch_sequence
from dynamo_tpu_torch.router import worker_key as torch_worker_key
from dynamo_tpu_torch.runtime import ControlPlaneServer, DistributedRuntime
from dynamo_tpu_torch.testing import tiny_tokenizer
from dynamo_tpu_torch.worker import serve_engine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 30  # seconds, every wait on the network or a background loop


def _ns(indexer, scheduler, sequence, worker_key, kv_router, tokens):
    return types.SimpleNamespace(
        RadixIndex=indexer.PyRadixIndex, ApproxKvIndexer=indexer.ApproxKvIndexer,
        KvWorkerSelector=scheduler.KvWorkerSelector,
        WorkerState=scheduler.WorkerState, ActiveSequences=sequence.ActiveSequences,
        pack_worker=worker_key.pack_worker, unpack_worker=worker_key.unpack_worker,
        KvRouter=kv_router.KvRouter, hashes=tokens.compute_block_hash_for_seq)


PKGS = {
    "jax": _ns(jax_indexer, jax_scheduler, jax_sequence, jax_worker_key,
               jax_kv_router, jax_tokens),
    "torch": _ns(torch_indexer, torch_scheduler, torch_sequence,
                 torch_worker_key, torch_kv_router, torch_tokens),
}


@pytest.fixture(params=["torch", "jax"])
def pkg(request):
    return PKGS[request.param]


async def until(cond, what, timeout=T):
    deadline = asyncio.get_running_loop().time() + timeout
    while not cond():
        assert asyncio.get_running_loop().time() < deadline, what
        await asyncio.sleep(0.02)


async def idle(router, n=2):
    """Until the router holds a metrics publication of every worker taken
    while it was idle: a publication from inside the last request counts
    its pages as load, which on these tiny pools outweighs a 5-block
    overlap."""
    await until(lambda: len(router.worker_states) == n and all(
        st.kv_usage == 0 for st in router.worker_states.values()),
        "idle metrics")


# -- the host cases of tests/test_kv_router.py, over both packages ----------- #


def test_radix_index_overlap(pkg):
    idx = pkg.RadixIndex()
    h = pkg.hashes(list(range(64)), 16)  # 4 blocks
    idx.apply_stored(1, h[:2])
    idx.apply_stored(2, h[:4])
    assert idx.find_matches(h) == {1: 2, 2: 4}
    # removal breaks the chain at the removed block
    idx.apply_removed(2, [h[1]])
    assert idx.find_matches(h) == {1: 2, 2: 1}
    idx.remove_worker(1)
    assert idx.find_matches(h) == {2: 1}
    assert idx.workers() == [2] and idx.num_blocks(2) == 3


def test_radix_snapshot_roundtrip(pkg):
    idx = pkg.RadixIndex()
    h = pkg.hashes(list(range(48)), 16)
    idx.apply_stored(7, h)
    idx2 = pkg.RadixIndex.from_snapshot(idx.snapshot())
    assert idx2.find_matches(h) == {7: 3}
    assert idx2.snapshot() == {7: sorted(h)}


def test_radix_randomized_equals_jax():
    """The same random op sequence on both packages' indexes: equal
    matches at every probe, equal snapshots at the end."""
    rng = random.Random(7)
    ref, idx = PKGS["jax"].RadixIndex(), PKGS["torch"].RadixIndex()
    universe = [rng.getrandbits(64) for _ in range(200)]
    probes = 0
    for _ in range(500):
        op = rng.random()
        w = rng.randrange(6)
        hs = rng.sample(universe, rng.randrange(1, 8))
        if op < 0.5:
            ref.apply_stored(w, hs)
            idx.apply_stored(w, hs)
        elif op < 0.8:
            ref.apply_removed(w, hs)
            idx.apply_removed(w, hs)
        elif op < 0.9:
            ref.remove_worker(w)
            idx.remove_worker(w)
        else:
            probe = rng.sample(universe, 16)
            assert ref.find_matches(probe) == idx.find_matches(probe)
            probes += 1
    assert probes > 10
    assert ref.snapshot() == idx.snapshot()
    assert ref.workers() == idx.workers()


def test_approx_indexer_ttl(pkg):
    now = [0.0]
    ap = pkg.ApproxKvIndexer(ttl_secs=10, clock=lambda: now[0])
    h = pkg.hashes(list(range(32)), 16)
    ap.process_routing_decision(3, h)
    ap.process_routing_decision(4, h[:1])
    assert ap.find_matches(h) == {3: 2, 4: 1}
    now[0] = 5.0
    ap.process_routing_decision(4, h)  # refreshes 4's TTL
    now[0] = 11.0
    assert ap.find_matches(h) == {4: 2}
    ap.remove_worker(4)
    assert ap.find_matches(h) == {}


def test_selector_prefers_overlap_then_load(pkg):
    sel = pkg.KvWorkerSelector(overlap_score_weight=1.0, temperature=0.0)
    workers = {1: pkg.WorkerState(1), 2: pkg.WorkerState(2)}
    active = pkg.ActiveSequences()
    # worker 2 has 8 of 10 blocks cached
    d = sel.select(workers, {2: 8}, 10, active)
    assert (d.worker_id, d.overlap_blocks, d.costs) == (2, 8, {1: 20.0, 2: 12.0})
    # but if worker 2 is drowning in decode load, worker 1 wins
    for i in range(6):
        active.add_request(f"r{i}", 2, prefill_blocks=0, decode_blocks=10)
    d = sel.select(workers, {2: 8}, 10, active)
    assert d.worker_id == 1 and d.costs == {1: 20.0, 2: 72.0}
    # published load joins the estimate (pool-wide usage x pages)
    workers = {1: pkg.WorkerState(1, kv_usage=0.5, kv_total_pages=100),
               2: pkg.WorkerState(2)}
    assert sel.select(workers, {}, 4, pkg.ActiveSequences()).worker_id == 2


def test_selector_seeded_softmax_equals_jax():
    """At temperature > 0 both selectors draw the same worker sequence
    from the same seed, and the draw spreads."""
    chosen = {}
    for name, p in PKGS.items():
        sel = p.KvWorkerSelector(temperature=10.0, rng=random.Random(1234))
        workers = {i: p.WorkerState(i) for i in range(4)}
        active = p.ActiveSequences()
        chosen[name] = [sel.select(workers, {i % 4: 2}, 4, active).worker_id
                        for i in range(100)]
    assert chosen["torch"] == chosen["jax"]
    assert len(set(chosen["torch"])) > 1


def test_selector_tier_overlap_prefers_host_tier_worker(pkg):
    sel = pkg.KvWorkerSelector()
    workers = {1: pkg.WorkerState(1), 2: pkg.WorkerState(2)}
    active = pkg.ActiveSequences()
    d = sel.select(workers, {}, 8, active, tier_overlaps={1: 6})
    assert d.worker_id == 1
    assert d.tier_overlap_blocks == 6 and d.overlap_blocks == 0
    # equal-depth device residency beats tier residency
    d = sel.select(workers, {2: 6}, 8, active, tier_overlaps={1: 6})
    assert d.worker_id == 2 and d.tier_overlap_blocks == 0
    # a much deeper tier run beats a shallow device run
    d = sel.select(workers, {2: 2}, 8, active, tier_overlaps={1: 7})
    assert d.worker_id == 1 and d.tier_overlap_blocks == 7


def test_router_tier_summary_replace_and_drop(pkg):
    router = pkg.KvRouter(None, "dynamo", "backend", None)
    h = pkg.hashes(list(range(64)), 16)  # 4 blocks
    router._apply_summary(5, {"host": h[:3], "disk": h[3:]})
    assert router.tier_index.find_matches(h) == {5: 4}
    router._apply_summary(5, {"host": h[:2], "disk": []})
    assert router.tier_index.find_matches(h) == {5: 2}  # replaced, not merged
    router.tier_index.remove_worker(5)  # what the delete/forget path runs
    assert router.tier_index.find_matches(h) == {}


def test_router_applies_events(pkg):
    router = pkg.KvRouter(None, "dynamo", "backend", None)
    h = pkg.hashes(list(range(64)), 16)
    router._apply_event({"worker_id": 3, "kind": "stored", "block_hashes": h})
    router._apply_event({"worker_id": 4, "kind": "stored", "block_hashes": h[:2]})
    router._apply_event({"worker_id": 3, "kind": "removed",
                         "block_hashes": [h[3]]})
    assert router.index.find_matches(h) == {3: 3, 4: 2}
    router._apply_event({"worker_id": 3, "kind": "cleared", "block_hashes": []})
    assert router.index.find_matches(h) == {4: 2}


def test_active_sequences(pkg):
    now = [0.0]
    act = pkg.ActiveSequences(expiry_secs=100, clock=lambda: now[0])
    act.add_request("a", 1, prefill_blocks=3, decode_blocks=5)
    act.add_request("b", 1, prefill_blocks=2, decode_blocks=4)
    act.add_request("c", 2, prefill_blocks=1, decode_blocks=1)
    assert act.load(1) == (5, 9) and act.active_count() == 3
    act.mark_prefill_done("a")
    assert act.load(1) == (2, 9) and act.active_count(1) == 2
    act.free("b")
    assert act.load(1) == (0, 5)
    act.remove_worker(1)
    assert act.load(1) == (0, 0) and act.active_count() == 1
    now[0] = 101.0
    assert act.load(2) == (0, 0)  # expired


def test_worker_key(pkg):
    assert pkg.pack_worker(7, 3) == 7 * 1024 + 3
    assert pkg.unpack_worker(pkg.pack_worker(123456789, 1023)) == (123456789, 1023)
    assert pkg.unpack_worker(pkg.pack_worker(5)) == (5, 0)
    with pytest.raises(ValueError):
        pkg.pack_worker(1, 1024)


# -- block hashes -------------------------------------------------------------- #


@pytest.fixture(scope="module")
def native_tokens_lib(tmp_path_factory):
    """The JAX package's native block hasher, built from its source into a
    temporary directory (`make -C native` builds the same file)."""
    out = tmp_path_factory.mktemp("native") / "libdynamo_tokens.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-fPIC", "-shared", "-o",
                    str(out), os.path.join(ROOT, "native", "block_hash.cpp")],
                   check=True, timeout=120)
    lib = ctypes.CDLL(str(out))
    u32p, u64p = ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint64)
    lib.dyn_block_hashes.argtypes = [u32p, ctypes.c_uint64, ctypes.c_uint64,
                                     ctypes.c_uint64, u64p]
    lib.dyn_block_hashes.restype = ctypes.c_uint64
    return lib


@pytest.mark.parametrize("backend", ["python", "native"])
@pytest.mark.parametrize("salt", ["", "tenant-a"])
def test_block_hashes_equal_jax(backend, salt, request, monkeypatch):
    if backend == "python":
        monkeypatch.setattr(jax_tokens, "_native_lib", lambda: None)
        lib = None
    else:
        lib = request.getfixturevalue("native_tokens_lib")
    rng = np.random.default_rng(len(salt) * 31 + len(backend))
    for n, bs in ((0, 16), (15, 16), (16, 16), (1000, 16), (257, 8),
                  (4096, 64), (33, 32)):
        toks = [int(t) for t in rng.integers(0, 1 << 31, n)]
        if lib is None:
            want = jax_tokens.compute_block_hash_for_seq(toks, bs, salt)
        else:
            want = jax_tokens._native_block_hashes(
                lib, toks, bs, jax_tokens.chain_seed(salt))
        assert torch_tokens.compute_block_hash_for_seq(toks, bs, salt) == want
        assert len(want) == n // bs


# -- the wire ------------------------------------------------------------------- #


class _FakeLoop:
    def __init__(self):
        self.calls = []

    def is_closed(self):
        return False

    def call_soon_threadsafe(self, fn, arg):
        self.calls.append(arg)


def test_event_and_metrics_payloads_equal_jax():
    """KV-event and metrics payloads are the JAX package's bytes."""
    from dynamo_tpu.engine.page_pool import KvEvent as JaxKvEvent
    from dynamo_tpu_torch.engine import ForwardPassMetrics
    from dynamo_tpu_torch.engine.page_pool import KvEvent

    payloads = {}
    for name, mod, ev in (("jax", jax_publisher, JaxKvEvent),
                          ("torch", torch_publisher, KvEvent)):
        pub = mod.KvEventPublisher.__new__(mod.KvEventPublisher)
        pub.worker_id, pub.dp_rank = torch_worker_key.pack_worker(1234, 0), 0
        pub._loop = _FakeLoop()
        pub._queue = types.SimpleNamespace(put_nowait=None)
        for e in (ev("stored", [2**64 - 1, 5], 17), ev("removed", [9]),
                  ev("cleared", [])):
            pub.sink(e)
        payloads[name] = pub._loop.calls
    assert payloads["torch"] == payloads["jax"]
    assert (torch_publisher.kv_stream_name("ns", "c"),
            torch_publisher.metrics_subject("ns", "c")) == (
        jax_publisher.kv_stream_name("ns", "c"),
        jax_publisher.metrics_subject("ns", "c"))
    from dynamo_tpu.runtime.transport.wire import unpack as jax_unpack
    from dynamo_tpu_torch.runtime.transport.wire import pack

    m = ForwardPassMetrics(active_seqs=2, kv_usage=0.25, kv_total_pages=63,
                           decode_cc_fallout_total={"stop": 3})
    m.kvbm_host_blocks = 4
    got = jax_unpack(pack({"worker_id": 7, **vars(m)}))
    assert got["worker_id"] == 7 and got["kv_usage"] == 0.25
    assert got["decode_cc_fallout_total"] == {"stop": 3}
    assert got["kvbm_host_blocks"] == 4


class _FakeControl:
    """The object-store and stream-fetch ops a router's sync reads."""

    def __init__(self):
        self.objects = {}

    async def obj_put(self, bucket, name, data):
        self.objects[(bucket, name)] = data

    async def obj_get(self, bucket, name):
        return self.objects.get((bucket, name))


@pytest.mark.parametrize("writer,reader", [("torch", "jax"), ("jax", "torch")])
async def test_snapshot_written_by_one_package_resumes_the_other(writer, reader):
    """A radix snapshot is stored under the same bucket and name by both
    packages and resumes either package's router at its offset."""
    control = _FakeControl()
    rt = types.SimpleNamespace(control=control)
    w = PKGS[writer].KvRouter(rt, "dynamo", "backend", None,
                              snapshot_threshold=1)
    h = PKGS[writer].hashes(list(range(64)), 16)
    w.index.apply_stored(PKGS[writer].pack_worker(3), h)
    w._events_seen, w._event_offset = 5, 42
    await w._maybe_snapshot()
    assert list(control.objects) == [(jax_kv_router.SNAPSHOT_BUCKET,
                                      "dynamo.backend@v2")]
    r = PKGS[reader].KvRouter(rt, "dynamo", "backend", None)
    assert r.snapshot_name == w.snapshot_name
    await r._load_snapshot()
    assert r._event_offset == 42
    assert r.index.find_matches(h) == {3 * 1024: 4}


async def test_resync_after_gap_equals_jax():
    """Events lost past retention with no newer snapshot: both routers
    drop the stale index and resume at the first available event."""
    states = {}
    for name, p in PKGS.items():
        rt = types.SimpleNamespace(control=_FakeControl())
        router = p.KvRouter(rt, "dynamo", "backend", None)
        router.index.apply_stored(1, [1, 2, 3])
        router._event_offset = 4
        await router._resync_after_gap(first_avail=10)
        states[name] = (router._event_offset, router.index.snapshot())
    assert states["torch"] == states["jax"] == (9, {})


# -- end to end on the CPU: the port's frontend in kv mode ------------------- #

ECFG = dict(page_size=8, num_pages=64, max_num_seqs=4, max_prefill_tokens=64,
            max_model_len=256)
MODEL = "tiny-chat"


@pytest.fixture(scope="module")
def jax_params():
    tok = jax_tiny_tokenizer()
    return jax_init_params(jax_tiny_config(vocab_size=tok.vocab_size),
                           jax.random.PRNGKey(0), dtype=jnp.float32)


def port_engine(params, **over):
    tok = tiny_tokenizer()
    cfg = tiny_config(vocab_size=tok.vocab_size)
    model = params_from_jax(cfg, jax.tree.map(np.asarray, params), device="cpu")
    return TorchEngine(cfg, model, EngineConfig(**{**ECFG, **over}),
                       eos_token_ids=list(tok.eos_token_ids), device="cpu")


def port_card():
    tok = tiny_tokenizer()
    return ModelDeploymentCard(name=MODEL, tokenizer_json=tok.to_json_str(),
                               eos_token_ids=list(tok.eos_token_ids))


def prompt(seed, n=40):
    rng = random.Random(seed)
    return [rng.randrange(4, 250) for _ in range(n)]


def completion(toks):
    return {"model": MODEL, "prompt": toks, "max_tokens": 4, "temperature": 0,
            "nvext": {"ignore_eos": True}}


def served_by(engines, before):
    """Index of the one engine whose request count rose since `before`."""
    now = [e.metrics().num_requests_total for e in engines]
    rose = [i for i, (a, b) in enumerate(zip(before, now)) if b > a]
    assert len(rose) == 1, (before, now)
    return rose[0]


async def port_workers(address, engines):
    rts, served = [], []
    for engine in engines:
        rt = await DistributedRuntime.connect(address)
        served.append(await serve_engine(rt, engine, port_card()))
        rts.append(rt)
    return rts, served


async def test_port_frontend_kv_routes_returning_prefix_to_holder(jax_params):
    import aiohttp

    from dynamo_tpu_torch.frontend import HttpService, ModelManager, ModelWatcher
    from dynamo_tpu_torch.router import AllWorkersBusy, kv_chooser_factory
    from dynamo_tpu_torch.router.scheduler import WorkerState

    control = await ControlPlaneServer().start()
    engines = [port_engine(jax_params), port_engine(jax_params)]
    rts, served = await port_workers(control.address, engines)
    front = await DistributedRuntime.connect(control.address)
    watcher = await ModelWatcher(
        front, ModelManager(), router_mode="kv",
        kv_chooser_factory=kv_chooser_factory(front)).start()
    http = None
    try:
        entry = await asyncio.wait_for(watcher.wait_for_model(MODEL), T)
        await until(lambda: len(entry.instances) == 2, "both workers")
        router = entry.kv_chooser
        http = await HttpService(watcher.manager, host="127.0.0.1",
                                 port=0).start()
        base = f"http://127.0.0.1:{http.port}/v1/completions"
        prompts = [prompt(s) for s in (1, 2, 3)]  # 5 full pages each
        holders = []
        async with aiohttp.ClientSession() as session:
            for p in prompts:
                before = [e.metrics().num_requests_total for e in engines]
                async with session.post(base, json=completion(p)) as r:
                    assert r.status == 200, await r.text()
                holders.append(served_by(engines, before))
                hashes = torch_tokens.compute_block_hash_for_seq(p, 8)
                await until(lambda: router.index.find_matches(hashes),
                            "kv events reach the router")
            wids = {e: torch_worker_key.pack_worker(s.instance.instance_id)
                    for e, s in enumerate(served)}
            for p, holder in zip(prompts, holders):
                await idle(router)
                before = [e.metrics() for e in engines]
                async with session.post(base, json=completion(p + [7, 8])) as r:
                    assert r.status == 200, await r.text()
                assert served_by(engines, [m.num_requests_total
                                           for m in before]) == holder
                assert router.last_decision.worker_id == wids[holder]
                assert router.last_decision.overlap_blocks == 5
                cached = (engines[holder].metrics().prefix_cached_tokens_total
                          - before[holder].prefix_cached_tokens_total)
                assert cached >= 40
            # the index mirrors each pool's cached blocks
            for e, engine in enumerate(engines):
                await until(lambda: router.index.num_blocks(wids[e])
                            == len(engine.pool._cached), "index == pool")
            # every worker busy → 503, through the HTTP frontend
            router.busy_threshold = 0.5
            busy = {w: WorkerState(worker_id=w, kv_usage=0.99,
                                   kv_total_pages=63) for w in wids.values()}
            router._live_workers = lambda: busy
            with pytest.raises(AllWorkersBusy):
                await router.choose({"token_ids": prompts[0]})
            async with session.post(base, json=completion(prompts[0])) as r:
                assert r.status == 503, await r.text()
    finally:
        if http is not None:
            await http.stop()
        await watcher.stop()
        for s in served:
            await s.deregister()
        for e in engines:
            await e.shutdown()
        for rt in rts + [front]:
            await rt.shutdown(graceful=False)
        await control.stop()


async def test_clear_kv_blocks_empties_the_workers_index(jax_params):
    """`clear_kv_blocks` through the worker's control op publishes a
    cleared event: the router's count for that worker falls to 0."""
    from dynamo_tpu_torch.router import KvRouter

    control = await ControlPlaneServer().start()
    engines = [port_engine(jax_params)]
    rts, served = await port_workers(control.address, engines)
    front = await DistributedRuntime.connect(control.address)
    client = await front.namespace("dynamo").component("backend") \
        .endpoint("generate").client().start()
    router = await KvRouter(front, "dynamo", "backend", client,
                            block_size=8).start()
    try:
        await client.wait_for_instances()
        iid = served[0].instance.instance_id
        req = {"token_ids": prompt(5), "sampling_options": {"temperature": 0.0},
               "stop_conditions": {"max_tokens": 2, "ignore_eos": True}}
        async for _ in client.direct(req, iid):
            pass
        wid = torch_worker_key.pack_worker(iid)
        await until(lambda: router.index.num_blocks(wid) == 5, "events")
        outs = [o async for o in client.direct(
            {"control": "clear_kv_blocks"}, iid)]
        assert outs[0]["pages_cleared"] == 5
        await until(lambda: router.index.num_blocks(wid) == 0, "cleared")
    finally:
        await router.stop()
        await client.stop()
        for s in served:
            await s.deregister()
        await engines[0].shutdown()
        for rt in rts + [front]:
            await rt.shutdown(graceful=False)
        await control.stop()


async def test_clear_kv_blocks_waits_for_a_fused_chains_deferred_frees(jax_params):
    """The race's window, forced: a fused prefill->decode request's last
    output reaches the loop while its pages still sit in the step's
    deferred frees (held there until the clear has been sent).  The
    worker's clear must wait for the step and reclaim every committed
    page, with the pool's LRU empty after it."""
    import threading
    import time

    from dynamo_tpu_torch.runtime import Context
    from dynamo_tpu_torch.worker import EngineWorker

    engine = port_engine(jax_params)
    assert engine.cfg.fuse_prefill_decode
    worker = EngineWorker(engine)
    ended = threading.Event()
    window = []
    free = engine.pool.free

    def held_free(pages):
        # the step thread's frees wait for the stream's end at the loop,
        # then a little more, so an unordered clear would read first
        if pages and threading.current_thread().name.startswith("torch-engine-step"):
            if ended.wait(timeout=10):
                window.append(len(pages))
                time.sleep(0.2)
        return free(pages)

    engine.pool.free = held_free
    try:
        req = {"token_ids": prompt(5), "sampling_options": {"temperature": 0.0},
               "stop_conditions": {"max_tokens": 2, "ignore_eos": True}}
        outs = []
        async for out in engine.generate(req):
            outs.append(out)
            if out.get("finish_reason"):
                ended.set()
        cleared = [o async for o in worker.handle({"control": "clear_kv_blocks"},
                                                  Context())]
        assert window, "the finished request's pages were not held in a deferred free"
        assert cleared[0]["pages_cleared"] == 5
        assert not engine.pool._lru
    finally:
        engine.pool.free = free
        await engine.shutdown()


async def test_standalone_router_service_chooses_the_holder(jax_params):
    """`python -m dynamo_tpu_torch.router` over two port workers: its
    `choose` op names the worker holding a prefix, `finished` frees it."""
    control = await ControlPlaneServer().start()
    engines = [port_engine(jax_params), port_engine(jax_params)]
    rts, served = await port_workers(control.address, engines)
    env = {**os.environ, "PYTHONPATH": ROOT}
    proc = await asyncio.create_subprocess_exec(
        sys.executable, "-m", "dynamo_tpu_torch.router", "--control",
        control.address, "--target-component", "backend", "--block-size", "8",
        "--log-level", "warning", cwd=ROOT, env=env,
        stdout=asyncio.subprocess.PIPE)
    front = await DistributedRuntime.connect(control.address)
    try:
        line = (await asyncio.wait_for(proc.stdout.readline(), 120)).decode()
        assert line.startswith("READY router dynamo.router -> backend"), line
        router_client = await front.namespace("dynamo").component("router") \
            .endpoint("generate").client().start()
        workers = await front.namespace("dynamo").component("backend") \
            .endpoint("generate").client().start()
        await router_client.wait_for_instances()
        await workers.wait_for_instances()
        iid = served[1].instance.instance_id
        p = prompt(9)
        req = {"token_ids": p, "sampling_options": {"temperature": 0.0},
               "stop_conditions": {"max_tokens": 2, "ignore_eos": True}}
        async for _ in workers.direct(req, iid):
            pass

        async def ask(body):
            return [o async for o in router_client.round_robin(body)][0]

        want = torch_worker_key.pack_worker(iid)
        deadline = asyncio.get_running_loop().time() + T
        while True:  # until the service has indexed the events
            got = await ask({"op": "choose", "token_ids": p,
                             "request_id": "r1"})
            await ask({"op": "finished", "request_id": "r1"})
            if got == {"worker_id": want}:
                break
            assert asyncio.get_running_loop().time() < deadline, got
            await asyncio.sleep(0.1)
        assert await ask({"op": "finished", "request_id": "r1"}) == {
            "status": "ok"}
        assert "error" in await ask({"op": "nope"})
        await router_client.stop()
        await workers.stop()
    finally:
        proc.terminate()
        await asyncio.wait_for(proc.wait(), 30)
        for s in served:
            await s.deregister()
        for e in engines:
            await e.shutdown()
        for rt in rts + [front]:
            await rt.shutdown(graceful=False)
        await control.stop()


# -- across packages ------------------------------------------------------------ #


async def test_jax_frontend_kv_routes_to_port_workers(jax_params):
    """A JAX frontend in kv mode, over the JAX control plane, indexes the
    events of two port workers and sends a returning prefix to its
    holder."""
    from dynamo_tpu.frontend import ModelManager as JaxManager
    from dynamo_tpu.frontend import ModelWatcher as JaxWatcher
    from dynamo_tpu.router import kv_chooser_factory as jax_factory
    from dynamo_tpu.runtime import ControlPlaneServer as JaxControlPlane
    from dynamo_tpu.runtime import Context as JaxContext

    control = await JaxControlPlane().start()
    engines = [port_engine(jax_params), port_engine(jax_params)]
    rts, served = await port_workers(control.address, engines)
    front = await JaxRuntime.connect(control.address)
    watcher = await JaxWatcher(front, JaxManager(), router_mode="kv",
                               kv_chooser_factory=jax_factory(front)).start()
    try:
        entry = await asyncio.wait_for(watcher.wait_for_model(MODEL), T)
        await until(lambda: len(entry.instances) == 2, "both workers")

        def req(toks):
            return {"token_ids": toks, "sampling_options": {"temperature": 0.0},
                    "stop_conditions": {"max_tokens": 2, "ignore_eos": True}}

        for seed in (11, 12):
            p = prompt(seed)
            before = [e.metrics().num_requests_total for e in engines]
            async for _ in entry.route(req(p), JaxContext()):
                pass
            holder = served_by(engines, before)
            hashes = jax_tokens.compute_block_hash_for_seq(p, 8)
            await until(lambda: entry.kv_chooser.index.find_matches(hashes),
                        "port events reach the JAX router")
            await idle(entry.kv_chooser)
            before = [e.metrics().num_requests_total for e in engines]
            async for _ in entry.route(req(p + [3]), JaxContext()):
                pass
            assert served_by(engines, before) == holder
    finally:
        await watcher.stop()
        for s in served:
            await s.deregister()
        for e in engines:
            await e.shutdown()
        for rt in rts:
            await rt.shutdown(graceful=False)
        await front.shutdown(graceful=False)
        await control.stop()


async def test_port_router_routes_to_jax_workers():
    """The port's router, over the port's control plane, indexes the
    events of two JAX mock workers (`dynamo_tpu.worker.serve_engine`) and
    sends a returning prefix to its holder."""
    from dynamo_tpu_torch.router import KvRouter

    control = await ControlPlaneServer().start()
    engines, jax_rts = [], []
    for _ in range(2):
        rt = await JaxRuntime.connect(control.address)
        engine = MockEngine(MockEngineArgs(
            num_pages=128, page_size=16, max_num_seqs=8, max_prefill_tokens=256,
            max_model_len=2048, speedup_ratio=50.0))
        await jax_serve_engine(rt, engine, JaxCard(name="mock",
                                                   context_length=2048))
        engines.append(engine)
        jax_rts.append(rt)
    front = await DistributedRuntime.connect(control.address)
    client = await front.namespace("dynamo").component("backend") \
        .endpoint("generate").client().start()
    router = await KvRouter(front, "dynamo", "backend", client,
                            block_size=16).start()
    try:
        await client.wait_for_instances()
        await until(lambda: len(client.instances()) == 2, "both workers")
        await until(lambda: len(router.worker_states) == 2, "JAX metrics")
        for seed in (21, 22, 23):
            p = prompt(seed, n=64)
            r = {"token_ids": p, "sampling_options": {"seed": 1},
                 "stop_conditions": {"max_tokens": 4, "ignore_eos": True},
                 "request_id": f"a{seed}"}
            w1 = await router.choose(r)
            async for _ in client.direct(r, torch_worker_key.unpack_worker(w1)[0]):
                pass
            router.mark_finished(r["request_id"])
            hashes = torch_tokens.compute_block_hash_for_seq(p, 16)
            await until(lambda: router.index.find_matches(hashes).get(w1) == 4,
                        "JAX events reach the port router")
            await idle(router)
            w2 = await router.choose({**r, "request_id": f"b{seed}"})
            assert w2 == w1 and router.last_decision.overlap_blocks == 4
            router.mark_finished(f"b{seed}")
    finally:
        await router.stop()
        await client.stop()
        for e in engines:
            await e.shutdown()
        for rt in jax_rts:
            await rt.shutdown(graceful=False)
        await front.shutdown(graceful=False)
        await control.stop()


async def test_run_and_frontend_take_router_mode_kv(jax_params):
    """`--router-mode kv` and `--busy-threshold` parse in both launchers,
    an unknown mode stays an error, and `run`'s stack routes through a
    KvRouter built with the threshold."""
    import aiohttp

    from dynamo_tpu_torch.frontend import ModelWatcher
    from dynamo_tpu_torch.frontend.__main__ import build_parser
    from dynamo_tpu_torch.router import KvRouter
    from dynamo_tpu_torch.run.__main__ import parse_args, start_stack

    front = build_parser().parse_args(["--control", "h:1", "--router-mode",
                                       "kv", "--busy-threshold", "0.9"])
    assert (front.router_mode, front.busy_threshold) == ("kv", 0.9)
    with pytest.raises(SystemExit):
        build_parser().parse_args(["--control", "h:1", "--router-mode", "x"])
    with pytest.raises(ValueError, match="unknown router mode"):
        ModelWatcher(None, None, router_mode="x")
    with pytest.raises(ValueError, match="kv_chooser_factory"):
        ModelWatcher(None, None, router_mode="kv")
    args = parse_args(["--in", "http", "--device", "cpu", "--host",
                       "127.0.0.1", "--port", "0", "--router-mode", "kv",
                       "--busy-threshold", "0.9"])
    engine = port_engine(jax_params)
    runtime, watcher, http = await start_stack(args, engine, port_card())
    try:
        entry = watcher.manager.get(MODEL)
        assert isinstance(entry.kv_chooser, KvRouter)
        assert entry.kv_chooser.busy_threshold == 0.9
        async with aiohttp.ClientSession() as session:
            async with session.post(
                    f"http://127.0.0.1:{http.port}/v1/completions",
                    json=completion(prompt(31))) as r:
                assert r.status == 200, await r.text()
        assert entry.kv_chooser.last_decision is not None
    finally:
        await http.stop()
        await watcher.stop()
        await runtime.shutdown(graceful=False)
        await engine.shutdown()

"""The port's KVBM tiers (dynamo_tpu_torch.kvbm: HostBlockPool, DiskTier,
TieredKvCache, the leader/worker bootstrap) and TorchEngine's offload and
onboard paths, against the JAX package on the CPU.

The JAX package's tier unit tests (tests/test_kvbm.py) run as cases over
both packages' classes.  Its engine tier tests run on both engines with
the same tiny f32 weights: same tokens, same onboarded block counts, and
host blocks within 1e-5 of JaxEngine's.  The port's own round trips are
byte-exact, bf16 included (its disk files keep the raw 16-bit words).
"""

import asyncio
import contextlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu import kvbm as jax_kvbm
from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxEngine
from dynamo_tpu.models import init_params as jax_init_params
from dynamo_tpu.models import tiny_config as jax_tiny_config
from dynamo_tpu_torch import kvbm as torch_kvbm
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.models import params_from_jax, tiny_config

ECFG = dict(page_size=8, num_pages=64, max_num_seqs=4, max_prefill_tokens=64,
            max_model_len=256)
PKGS = {"torch": torch_kvbm, "jax": jax_kvbm}


@pytest.fixture(scope="module")
def jax_params():
    return jax_init_params(jax_tiny_config(), jax.random.PRNGKey(0),
                           dtype=jnp.float32)


@pytest.fixture(params=["torch", "jax"])
def pkg(request):
    return PKGS[request.param]


def torch_engine(jax_params, tiered=None, dtype=torch.float32, **over):
    cfg = tiny_config()
    model = params_from_jax(cfg, jax.tree.map(np.asarray, jax_params),
                            dtype=dtype, device="cpu")
    return TorchEngine(cfg, model, EngineConfig(**{**ECFG, **over}),
                       eos_token_ids=[], device="cpu", tiered=tiered)


def jax_engine(jax_params, tiered=None, **over):
    return JaxEngine(jax_tiny_config(), jax_params,
                     JaxEngineConfig(**{**ECFG, **over}), eos_token_ids=[],
                     kv_dtype=jnp.float32, tiered=tiered)


ENGINES = {"torch": torch_engine, "jax": jax_engine}


def req(tokens, max_tokens=4):
    return {
        "token_ids": tokens,
        "sampling_options": {"temperature": 0.0},
        "stop_conditions": {"max_tokens": max_tokens, "ignore_eos": True},
    }


async def collect(engine, request):
    out = []
    async for d in engine.generate(request):
        out.extend(d["token_ids"])
    return out


async def drained(tiered, min_host=1):
    deadline = asyncio.get_running_loop().time() + 10
    while tiered.offload_backlog or len(tiered.host) < min_host:
        assert asyncio.get_running_loop().time() < deadline, "no offload"
        await asyncio.sleep(0.02)


def host_close(t_tier, j_tier):
    """Blocks both host tiers hold agree within 1e-5 (f32)."""
    common = set(t_tier.host.summary()) & set(j_tier.host.summary())
    assert common
    for h in common:
        tb, jb = t_tier.host.get(h), j_tier.host.get(h)
        np.testing.assert_allclose(tb.k.numpy(), jb.k, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tb.v.numpy(), jb.v, rtol=1e-5, atol=1e-5)
        assert tb.parent_hash == jb.parent_hash


# -- the JAX tier unit tests, over both packages' classes -------------------- #


def test_host_pool_lru_and_bytes(pkg):
    evicted = []
    pool = pkg.HostBlockPool(capacity_bytes=4 * 1024, on_evict=evicted.append)
    k = np.zeros((2, 8, 2, 4), np.float32)  # 512B each; block = 1KiB
    for h in range(100, 106):
        pool.put(h, h - 1, k, k)
    assert len(pool) <= 4
    assert evicted and evicted[0].block_hash == 100
    assert pool.get(105) is not None
    assert pool.get(100) is None


def test_host_pool_lookup_refreshes_recency(pkg):
    pool = pkg.HostBlockPool(capacity_bytes=4 * 1024)
    k = np.zeros((2, 8, 2, 4), np.float32)  # 1KiB per block
    for h in (1, 2, 3, 4):
        pool.put(h, None, k, k)
    assert pool.get(1) is not None  # refresh 1 → LRU is now 2
    pool.put(5, None, k, k)
    assert 2 not in pool and 1 in pool
    assert pool.summary(2) == [5, 1]
    assert pool.hits == 1 and pool.evicted == 1


def test_host_pool_summary_order(pkg):
    pool = pkg.HostBlockPool(capacity_bytes=1 << 20)
    k = np.zeros((1, 2, 1, 2), np.float32)
    for h in (10, 11, 12):
        pool.put(h, None, k, k)
    pool.get(10)
    assert pool.summary() == [10, 12, 11]
    assert pool.summary(1) == [10]


def test_disk_tier_torn_file_is_a_miss(pkg, tmp_path):
    disk = pkg.DiskTier(str(tmp_path))
    k = np.ones((2, 8, 2, 2), np.float32)
    disk.put(0x10, None, k, k)
    torn = tmp_path / f"{0x22:016x}.npz"
    torn.write_bytes(b"PK\x03\x04 this is not a real zip")
    assert 0x22 in disk
    assert disk.get(0x22) is None
    assert not torn.exists()
    assert 0x22 not in disk
    got = disk.get(0x10)
    np.testing.assert_array_equal(np.asarray(got[0]), k)


def test_disk_tier_writes_are_atomic(pkg, tmp_path):
    disk = pkg.DiskTier(str(tmp_path))
    k = np.ones((2, 8, 2, 2), np.float32)
    disk.put(0xA1, None, k, k)
    names = {p.name for p in tmp_path.iterdir()}
    assert names == {f"{0xA1:016x}.npz"}
    (tmp_path / ".tmp-9999-00000000000000b2.npz").write_bytes(b"junk")
    disk2 = pkg.DiskTier(str(tmp_path))
    assert len(disk2) == 1 and 0xA1 in disk2


def test_disk_tier_put_overwrites_unverified_debris(pkg, tmp_path):
    h = 0x77
    (tmp_path / f"{h:016x}.npz").write_bytes(b"PK\x03\x04 torn debris")
    disk = pkg.DiskTier(str(tmp_path))
    assert h in disk
    assert not disk.has_verified(h)
    k = np.ones((2, 8, 2, 2), np.float32)
    disk.put(h, None, k, k * 3)
    assert disk.has_verified(h)
    got = disk.get(h)
    np.testing.assert_array_equal(np.asarray(got[1]), k * 3)
    assert disk.bytes_used == sum(disk._index.values())  # noqa: SLF001


def test_disk_tier_roundtrip(pkg, tmp_path):
    disk = pkg.DiskTier(str(tmp_path), capacity_bytes=1 << 20)
    k = np.arange(64, dtype=np.float32).reshape(2, 8, 2, 2)
    disk.put(0xABC, None, k, k * 2)
    got = disk.get(0xABC)
    np.testing.assert_array_equal(np.asarray(got[0]), k)
    np.testing.assert_array_equal(np.asarray(got[1]), k * 2)
    disk2 = pkg.DiskTier(str(tmp_path))
    assert 0xABC in disk2


# -- bf16 on the host and on disk --------------------------------------------- #


def test_disk_tier_bf16_roundtrip_is_byte_exact(tmp_path):
    """The port's disk files keep a bf16 plane's raw words: every bit
    pattern (NaNs, infinities, subnormals included) reads back as the
    same bf16 bits."""
    g = torch.Generator().manual_seed(3)
    k = torch.randint(-2**15, 2**15, (2, 8, 2, 4), dtype=torch.int16,
                      generator=g).view(torch.bfloat16)
    v = torch.randint(-2**15, 2**15, (2, 8, 2, 4), dtype=torch.int16,
                      generator=g).view(torch.bfloat16)
    torch_kvbm.DiskTier(str(tmp_path)).put(0x5, None, k, v)
    got = torch_kvbm.DiskTier(str(tmp_path)).get(0x5)  # a fresh process view
    assert got[0].dtype == got[1].dtype == torch.bfloat16
    assert torch.equal(got[0].view(torch.int16), k.view(torch.int16))
    assert torch.equal(got[1].view(torch.int16), v.view(torch.int16))


def test_jax_disk_tier_reads_bf16_back_as_void(tmp_path):
    """A property of the reference: `np.savez` of an `ml_dtypes.bfloat16`
    array reloads as dtype `|V2`, so the JAX DiskTier hands back void
    arrays for a bf16 pool, with the bits intact."""
    k = np.asarray(jnp.arange(32, dtype=jnp.bfloat16).reshape(2, 4, 2, 2))
    disk = jax_kvbm.DiskTier(str(tmp_path))
    disk.put(0x9, None, k, k)
    got = disk.get(0x9)[0]
    assert got.dtype.kind == "V" and got.dtype.itemsize == 2
    assert got.tobytes() == k.tobytes()


# -- engine tier paths, both engines ------------------------------------------ #


def tiers(name, host_bytes=64 << 20, disk_root=None):
    p = PKGS[name]
    return p.TieredKvCache(
        p.HostBlockPool(capacity_bytes=host_bytes),
        p.DiskTier(str(disk_root)) if disk_root is not None else None)


async def offload_onboard(jax_params, name, tiered, request, min_host=1):
    """Serve `request`, wait for its blocks to land in the tiers, clear the
    device cache, serve it again from the tiers."""
    engine = ENGINES[name](jax_params, tiered=tiered)
    want = await collect(engine, request)
    await drained(tiered, min_host)
    engine.clear_kv_blocks()
    assert engine.pool.evictable_pages == 0
    got = await collect(engine, request)
    await engine.shutdown()
    return want, got


async def test_offload_and_onboard_preserves_output(jax_params, tmp_path):
    prompt = list(range(1, 41))  # 5 full pages
    out = {}
    for name in ("torch", "jax"):
        t = tiers(name, disk_root=tmp_path / name)
        out[name] = await offload_onboard(jax_params, name, t, req(prompt), 5)
        out[name] += (t,)
    (want, got, t), (jwant, jgot, jt) = out["torch"], out["jax"]
    assert want == got == jwant == jgot
    # the last prompt block is never cache-hit, so 4 of the 5 onboard
    assert t.onboarded_blocks == jt.onboarded_blocks >= 4
    assert t.offloaded_blocks == jt.offloaded_blocks
    host_close(t, jt)


async def test_disk_promotion_path(jax_params, tmp_path):
    """Host tier of ~1 block: blocks demote to disk and onboard from it."""
    prompt = list(range(50, 90))
    out = {}
    for name in ("torch", "jax"):
        t = tiers(name, host_bytes=2 << 10, disk_root=tmp_path / name)
        out[name] = await offload_onboard(jax_params, name, t, req(prompt))
        assert len(t.disk) >= 1, name
        out[name] += (t,)
    (want, got, t), (jwant, jgot, jt) = out["torch"], out["jax"]
    assert want == got == jwant == jgot
    assert t.onboarded_blocks == jt.onboarded_blocks >= 4
    assert len(t.disk) == len(jt.disk)


@pytest.mark.parametrize("name", ["torch", "jax"])
async def test_offload_completes_off_step_thread(jax_params, name):
    """The step thread only launches the gather; the copy and the host
    insert land on the kvbm-offload drain thread."""
    p = PKGS[name]
    host = p.HostBlockPool(capacity_bytes=64 << 20)
    put_threads = []
    orig_put = host.put

    def spying_put(*a, **kw):
        put_threads.append(threading.current_thread().name)
        return orig_put(*a, **kw)

    host.put = spying_put
    tiered = p.TieredKvCache(host)
    engine = ENGINES[name](jax_params, tiered=tiered)
    assert await collect(engine, req(list(range(1, 41))))
    await drained(tiered)
    await engine.shutdown()
    assert put_threads, "no host copies happened"
    assert all(t.startswith("kvbm-offload") for t in put_threads), put_threads
    assert tiered.offloaded_blocks >= 4


@pytest.mark.parametrize("host_bytes", [64 << 20, 2 << 10],
                         ids=["dram", "disk"])
async def test_onboard_token_identity_seeded(jax_params, tmp_path, host_bytes):
    """A seeded prefill served from DRAM-onboarded — and, with a ~1-block
    host pool, disk-onboarded — blocks gives the cold run's tokens, and
    JaxEngine's."""
    prompt = list(range(7, 55))  # 6 full pages
    r = req(prompt, max_tokens=6)
    r["sampling_options"] = {"temperature": 0.8, "seed": 1234}
    out = {}
    for name in ("torch", "jax"):
        t = tiers(name, host_bytes=host_bytes, disk_root=tmp_path / name)
        out[name] = (*await offload_onboard(jax_params, name, t, r), t)
        if host_bytes < 4096:
            assert len(t.disk) >= 1
    (want, got, t), (jwant, jgot, jt) = out["torch"], out["jax"]
    assert want == got == jwant == jgot
    assert t.onboarded_blocks == jt.onboarded_blocks >= 4


async def test_onboard_leaves_watermark_reserve(jax_params):
    """Onboarding leaves `watermark + 1` pages free: a 9-block host run
    is clamped on a small pool, in both engines alike."""
    prompt = list(range(30, 110))  # 10 full pages
    seen = {}
    outs = {}
    for name in ("torch", "jax"):
        tiered = tiers(name)
        warm = ENGINES[name](jax_params, num_pages=64)
        warm.attach_connector(tiered)
        await collect(warm, req(prompt))
        await drained(tiered, 9)
        await warm.shutdown()
        engine = ENGINES[name](jax_params, tiered=tiered, num_pages=13,
                               watermark=0.25)
        wm = engine.scheduler._watermark_pages()  # noqa: SLF001
        assert wm >= 2
        seen[name] = []
        orig = engine.scheduler.onboard_fn

        def spy(hashes, rank=0, orig=orig, engine=engine, name=name):
            pages = orig(hashes, rank)
            seen[name].append((len(pages), engine.pool.available_on(rank)))
            return pages

        engine.scheduler.onboard_fn = spy
        outs[name] = await collect(engine, req(prompt))
        await engine.shutdown()
        assert seen[name], "onboard hook never ran"
        for n_pages, avail_after in seen[name]:
            assert n_pages == 0 or avail_after >= wm, (n_pages, avail_after)
        assert max(n for n, _ in seen[name]) <= engine.cfg.usable_pages - wm - 1
    assert outs["torch"] == outs["jax"]
    assert seen["torch"] == seen["jax"]


async def test_export_cached_blocks_sync_wrapper(jax_params):
    """The sync export and the device-chunk export it is built on give
    the same hashes and bytes, and JaxEngine's bytes within 1e-5."""
    prompt = list(range(1, 41))
    engine = torch_engine(jax_params)
    await collect(engine, req(prompt))
    hashes = list(engine.pool._cached)  # noqa: SLF001 — committed hashes
    assert hashes
    out_h, k, v = engine.export_cached_blocks(hashes + [0xDEAD])
    assert set(out_h) == set(hashes)
    (hs, kd, vd), = engine.export_cached_blocks_device(hashes)
    for i, h in enumerate(out_h):
        j = hs.index(h)
        assert torch.equal(k[:, i], kd[:, j]) and torch.equal(v[:, i], vd[:, j])
    await engine.shutdown()
    jeng = jax_engine(jax_params)
    await collect(jeng, req(prompt))
    jh, jk, jv = jeng.export_cached_blocks(hashes)
    await jeng.shutdown()
    assert jh == out_h
    np.testing.assert_allclose(k.numpy(), jk, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(v.numpy(), jv, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["torch", "jax"])
async def test_shutdown_with_pending_offloads_does_not_deadlock(jax_params, name):
    """shutdown() racing queued offloads terminates the pump (the idle
    branch re-checks _closed before parking on _wake)."""
    engine = ENGINES[name](jax_params, tiered=tiers(name))
    await collect(engine, req(list(range(1, 41))))
    await asyncio.wait_for(engine.shutdown(), timeout=60)
    assert engine._pump_task.done()  # noqa: SLF001


async def test_bf16_offload_onboard_is_byte_exact(jax_params, tmp_path):
    """A bf16 pool's blocks go to host, demote to disk, and onboard back
    into the pool with the same bits; the pool tensors are never
    reallocated by the imports."""
    tiered = tiers("torch", host_bytes=2 << 10, disk_root=tmp_path)
    engine = torch_engine(jax_params, tiered=tiered, dtype=torch.bfloat16)
    ptrs = (engine.kv.k.data_ptr(), engine.kv.v.data_ptr())
    prompt = list(range(11, 51))
    want = await collect(engine, req(prompt))
    await drained(tiered)
    hashes = sorted(engine.pool._cached, key=engine.pool._cached.get)  # noqa: SLF001
    h0, k0, v0 = engine.export_cached_blocks(hashes)
    assert len(tiered.disk) >= 4 and k0.dtype == torch.bfloat16
    engine.clear_kv_blocks()
    got = await collect(engine, req(prompt))
    h1, k1, v1 = engine.export_cached_blocks(h0)
    await engine.shutdown()
    assert got == want and tiered.onboarded_blocks >= 4
    common = [h for h in h0 if h in h1]
    assert len(common) >= 4
    for h in common:
        i, j = h0.index(h), h1.index(h)
        assert torch.equal(k0[:, i].view(torch.int16), k1[:, j].view(torch.int16))
        assert torch.equal(v0[:, i].view(torch.int16), v1[:, j].view(torch.int16))
    assert (engine.kv.k.data_ptr(), engine.kv.v.data_ptr()) == ptrs


def test_engine_metrics_carry_kvbm_fields(jax_params, tmp_path):
    """The kvbm_* fields of the port's metrics are JaxEngine's."""
    names = {}
    for name in ("torch", "jax"):
        t = tiers(name, disk_root=tmp_path / name)
        engine = ENGINES[name](jax_params, tiered=t)
        names[name] = sorted(k for k in vars(engine.metrics())
                             if k.startswith("kvbm_"))
        asyncio.run(engine.shutdown())
    assert names["torch"] == names["jax"] and len(names["torch"]) == 14


# -- distributed bootstrap ---------------------------------------------------- #


def test_kv_layout_matches_jax(jax_params):
    """The layout a port worker registers is the one a JAX worker with the
    same geometry registers (dtype names included)."""
    from dynamo_tpu.disagg.transfer import KvLayout as JaxKvLayout

    engine = torch_engine(jax_params)
    jeng = jax_engine(jax_params)
    assert (torch_kvbm.KvLayout.of_engine(engine).to_dict()
            == JaxKvLayout.of_engine(jeng).to_dict())
    bf = torch_engine(jax_params, dtype=torch.bfloat16)
    assert torch_kvbm.KvLayout.of_engine(bf).dtype == "bfloat16"
    assert (torch_kvbm.KvbmConfig(disk_root="/x").to_dict().keys()
            == jax_kvbm.KvbmConfig(disk_root="/x").to_dict().keys())


async def test_kvbm_barrier_rejects_layout_mismatch(jax_params):
    from dynamo_tpu_torch.runtime import ControlPlaneServer, DistributedRuntime

    control = await ControlPlaneServer().start()
    rt_a = await DistributedRuntime.connect(control.address)
    rt_b = await DistributedRuntime.connect(control.address)
    engine_a = torch_engine(jax_params, page_size=8)
    engine_b = torch_engine(jax_params, page_size=16)  # different geometry
    try:
        leader = asyncio.ensure_future(torch_kvbm.KvbmLeader(
            rt_a, torch_kvbm.KvbmConfig(host_bytes=1 << 20), world=2,
        ).start())
        wa = asyncio.ensure_future(
            torch_kvbm.KvbmWorker(rt_a, engine_a).start(timeout=5))
        wb = asyncio.ensure_future(
            torch_kvbm.KvbmWorker(rt_b, engine_b).start(timeout=5))
        with pytest.raises(ValueError, match="layout mismatch"):
            await leader
        for t in (wa, wb):
            t.cancel()
        await asyncio.gather(wa, wb, return_exceptions=True)
    finally:
        await engine_a.shutdown()
        await engine_b.shutdown()
        await rt_a.shutdown(graceful=False)
        await rt_b.shutdown(graceful=False)
        await control.stop()


async def test_distributed_kvbm_shared_disk(jax_params, tmp_path):
    """Two port workers bootstrap through the leader barrier and share a
    disk tier: blocks worker A demoted onboard on worker B, which never
    computed the prompt, with A's tokens."""
    from dynamo_tpu_torch.runtime import ControlPlaneServer, DistributedRuntime

    prompt = list(range(1, 65))  # 8 full pages
    control = await ControlPlaneServer().start()
    rt_a = await DistributedRuntime.connect(control.address)
    rt_b = await DistributedRuntime.connect(control.address)
    engine_a = torch_engine(jax_params)
    engine_b = torch_engine(jax_params)
    try:
        leader = asyncio.ensure_future(torch_kvbm.KvbmLeader(
            rt_a, torch_kvbm.KvbmConfig(disk_root=str(tmp_path / "g3"),
                                        host_bytes=1), world=2).start())
        ta, tb = await asyncio.gather(
            torch_kvbm.KvbmWorker(rt_a, engine_a).start(),
            torch_kvbm.KvbmWorker(rt_b, engine_b).start())
        await leader
        assert engine_a.tiered is ta and engine_b.tiered is tb
        want = await collect(engine_a, req(prompt))
        await drained(ta, 0)
        await engine_a.shutdown()
        assert len(ta.disk) > 0
        got = await collect(engine_b, req(prompt))
        assert got == want
        assert tb.onboarded_blocks > 0
    finally:
        await engine_b.shutdown()
        await rt_a.shutdown(graceful=False)
        await rt_b.shutdown(graceful=False)
        await control.stop()


# -- the object-store tier (G4), the tier summary, tier-aware routing --------- #


@contextlib.asynccontextmanager
async def threaded_control_plane():
    """The port's ControlPlaneServer on a thread and event loop of its own
    (as in production, where it is another process): admission-time G4
    reads block the engine's loop while they talk to it."""
    from dynamo_tpu_torch.runtime import ControlPlaneServer

    started, holder = threading.Event(), {}

    def run():
        loop = asyncio.new_event_loop()
        server = loop.run_until_complete(ControlPlaneServer().start())
        holder["loop"], holder["server"] = loop, server
        started.set()
        loop.run_forever()

    t = threading.Thread(target=run, name="test-control-plane", daemon=True)
    t.start()
    assert started.wait(10)
    try:
        yield holder["server"].address
    finally:
        loop = holder["loop"]
        fut = asyncio.run_coroutine_threadsafe(holder["server"].stop(), loop)
        await asyncio.to_thread(fut.result, 10)
        loop.call_soon_threadsafe(loop.stop)
        await asyncio.to_thread(t.join, 10)


async def test_distributed_kvbm_g4_object_store(jax_params):
    """No disk: demotions land in the shared control-plane object store
    (G4) and the second worker, which never computed the prompt, onboards
    them: A's tokens, and device pages byte-equal to A's."""
    from dynamo_tpu_torch.runtime import DistributedRuntime

    prompt = list(range(101, 165))  # 8 full pages
    async with threaded_control_plane() as address:
        rt_a = await DistributedRuntime.connect(address)
        rt_b = await DistributedRuntime.connect(address)
        engine_a = torch_engine(jax_params)
        engine_b = torch_engine(jax_params)
        try:
            leader = asyncio.ensure_future(torch_kvbm.KvbmLeader(
                rt_a, torch_kvbm.KvbmConfig(g4_bucket="kvbm-test",
                                            host_bytes=1), world=2).start())
            ta, tb = await asyncio.gather(
                torch_kvbm.KvbmWorker(rt_a, engine_a).start(),
                torch_kvbm.KvbmWorker(rt_b, engine_b).start())
            await leader
            assert ta.remote is not None and ta.disk is None
            want = await collect(engine_a, req(prompt))
            await drained(ta, 0)
            hashes = sorted(engine_a.pool._cached, key=engine_a.pool._cached.get)  # noqa: SLF001
            ha, ka, va = engine_a.export_cached_blocks(hashes)
            await engine_a.shutdown()
            names = await rt_b.control.obj_list("kvbm-test")
            assert len(names) >= 7
            got = await collect(engine_b, req(prompt))
            assert got == want
            assert tb.onboarded_blocks >= 7
            # the onboarded run: every prompt block but the last, whose
            # last token B computes itself
            from dynamo_tpu_torch.tokens import compute_block_hash_for_seq

            run = compute_block_hash_for_seq(prompt, 8)[:7]
            hb, kb, vb = engine_b.export_cached_blocks(run)
            assert hb == run
            for j, h in enumerate(run):
                i = ha.index(h)
                assert torch.equal(ka[:, i], kb[:, j])
                assert torch.equal(va[:, i], vb[:, j])
                blob_k, blob_v = tb.remote.get(h)
                assert torch.equal(blob_k, ka[:, i]) and torch.equal(blob_v, va[:, i])
        finally:
            await engine_b.shutdown()
            await rt_a.shutdown(graceful=False)
            await rt_b.shutdown(graceful=False)


@pytest.mark.parametrize("writer", ["torch", "jax"])
async def test_g4_blobs_are_shared_across_packages(writer):
    """A block one package puts in the object store, the other gets back
    byte for byte (f32 and bf16): the blob is the same msgpack map."""
    import ml_dtypes

    from dynamo_tpu.kvbm.remote import ObjectStoreTier as JaxTier

    from dynamo_tpu_torch.kvbm import ObjectStoreTier

    rng = np.random.default_rng(3)
    f32 = rng.standard_normal((2, 8, 2, 4), dtype=np.float32)
    bf16 = f32.astype(ml_dtypes.bfloat16)
    async with threaded_control_plane() as address:
        tiers_ = {"torch": ObjectStoreTier(address, "b"),
                  "jax": JaxTier(address, "b")}
        reader = tiers_["jax" if writer == "torch" else "torch"]
        try:
            for h, arr in ((1, f32), (2, bf16)):
                k, v = arr, arr[::-1].copy()
                if writer == "torch":
                    k = torch.from_numpy(k.view(np.int16)).view(torch.bfloat16) \
                        if arr.dtype == bf16.dtype else torch.from_numpy(k)
                    v = torch.from_numpy(v.view(np.int16)).view(torch.bfloat16) \
                        if arr.dtype == bf16.dtype else torch.from_numpy(v)
                await asyncio.to_thread(tiers_[writer].put, h, None, k, v)
                # (another process's uploads are discovered on get)
                gk, gv = await asyncio.to_thread(reader.get, h)
                assert await asyncio.to_thread(reader.__contains__, h)
                for got, want in ((gk, arr), (gv, arr[::-1])):
                    if isinstance(got, torch.Tensor):
                        got = (got.view(torch.int16).numpy()
                               if got.dtype == torch.bfloat16 else got.numpy())
                    assert np.asarray(got).tobytes() == np.ascontiguousarray(
                        want).tobytes()
        finally:
            for t in tiers_.values():
                await asyncio.to_thread(t.close)


async def test_tier_summary_publisher_dedups_unchanged():
    """The worker-side publisher writes lease-scoped, skips rewriting an
    unchanged summary, and carries host and disk hashes."""
    from dynamo_tpu_torch.runtime import ControlPlaneServer, DistributedRuntime
    from dynamo_tpu_torch.runtime.transport.wire import unpack

    control = await ControlPlaneServer().start()
    rt = await DistributedRuntime.connect(control.address)
    try:
        tiered = torch_kvbm.TieredKvCache(
            torch_kvbm.HostBlockPool(capacity_bytes=1 << 20))
        pub = torch_kvbm.TierSummaryPublisher(rt, tiered, "dynamo", "backend",
                                              worker_id=77)
        assert pub.key == "/kvbm/summary/dynamo/backend/77"
        k = torch.zeros((1, 2, 1, 2))
        tiered.host.put(0xAB, None, k, k)
        p1 = await pub.publish_once()
        assert p1 is not None and p1["host"] == [0xAB] and p1["disk"] == []
        assert unpack(await rt.control.get(pub.key))["host"] == [0xAB]
        assert await pub.publish_once() is None  # unchanged → no rewrite
        tiered.host.put(0xCD, None, k, k)
        p3 = await pub.publish_once()
        assert p3["seq"] == 2 and set(p3["host"]) == {0xCD, 0xAB}
        await rt.shutdown(graceful=False)  # lease revoked: the key goes
        rt = await DistributedRuntime.connect(control.address)
        assert await rt.control.get(pub.key) is None
    finally:
        await rt.shutdown(graceful=False)
        await control.stop()


async def test_kvbm_stack_remote_prefix_hit(jax_params, monkeypatch):
    """The in-process `scripts/kvbm_stack.py`: two port workers with small
    device pools and host tiers behind the port's frontend in kv mode.
    After filler prompts churn the warm worker's device cache, the router
    sends the warm prefix to the worker whose HOST TIER holds it, with
    tier overlap in its decision, and that worker onboards it."""
    from dynamo_tpu_torch.frontend import ModelManager, ModelWatcher
    from dynamo_tpu_torch.llm import ModelDeploymentCard
    from dynamo_tpu_torch.router import kv_chooser_factory
    from dynamo_tpu_torch.router.worker_key import pack_worker
    from dynamo_tpu_torch.runtime import (
        ControlPlaneServer,
        Context,
        DistributedRuntime,
    )
    from dynamo_tpu_torch.testing import tiny_tokenizer
    from dynamo_tpu_torch.tokens import compute_block_hash_for_seq
    from dynamo_tpu_torch.worker import serve_engine

    monkeypatch.setenv("DYN_TPU_KVBM_SUMMARY_INTERVAL", "0.1")
    tok = tiny_tokenizer()
    control = await ControlPlaneServer().start()
    tiers_ = [tiers("torch"), tiers("torch")]
    engines = [torch_engine(jax_params, tiered=t, num_pages=24) for t in tiers_]
    rts, served = [], []
    for engine in engines:
        rt = await DistributedRuntime.connect(control.address)
        served.append(await serve_engine(rt, engine, ModelDeploymentCard(
            name="tiny", tokenizer_json=tok.to_json_str())))
        rts.append(rt)
    front = await DistributedRuntime.connect(control.address)
    watcher = await ModelWatcher(
        front, ModelManager(), router_mode="kv",
        kv_chooser_factory=kv_chooser_factory(front)).start()
    try:
        entry = await asyncio.wait_for(watcher.wait_for_model("tiny"), 30)
        deadline = asyncio.get_running_loop().time() + 30
        while len(entry.instances) < 2:
            assert asyncio.get_running_loop().time() < deadline
            await asyncio.sleep(0.02)
        router = entry.kv_chooser

        async def route(tokens):
            out = []
            async for d in entry.route(req(tokens), Context()):
                out.extend(d["token_ids"])
            return out

        warm = list(range(1, 49))  # 6 full pages
        hashes = compute_block_hash_for_seq(warm, 8)
        before = [e.metrics().num_requests_total for e in engines]
        want = await route(warm)
        w = next(i for i, e in enumerate(engines)
                 if e.metrics().num_requests_total > before[i])
        wid = pack_worker(served[w].instance.instance_id)
        await drained(tiers_[w], 6)
        # churn the warm worker's device cache with distinct fillers,
        # straight into its engine (the other worker stays cold)
        for i in range(6):
            await collect(engines[w], req([100 + 20 * i + j for j in range(64)]))
            if engines[w].pool.peek(hashes) == 0:
                break
        assert engines[w].pool.peek(hashes) == 0, "device copy not evicted"

        def settled():
            # the device copy gone, the host copy summarized, and a load
            # publication of each worker taken while it idled (an
            # in-flight one outweighs a 6-block overlap on these pools)
            return (router.index.find_matches(hashes).get(wid, 0) == 0
                    and router.tier_index.find_matches(hashes).get(wid) == 6
                    and len(router.worker_states) == 2
                    and all(st.kv_usage == 0
                            for st in router.worker_states.values()))

        deadline = asyncio.get_running_loop().time() + 30
        while not settled():
            assert asyncio.get_running_loop().time() < deadline, "summary"
            await asyncio.sleep(0.05)
        onboarded = tiers_[w].onboarded_blocks
        before = [e.metrics().num_requests_total for e in engines]
        got = await route(warm)
        assert engines[w].metrics().num_requests_total == before[w] + 1
        assert router.last_decision.worker_id == wid
        assert router.last_decision.tier_overlap_blocks >= 5
        assert tiers_[w].onboarded_blocks - onboarded >= 5
        assert got == want
    finally:
        await watcher.stop()
        for s in served:
            await s.deregister()
        for e in engines:
            await e.shutdown()
        for rt in rts + [front]:
            await rt.shutdown(graceful=False)
        await control.stop()

"""Disaggregated prefill/decode in the port (`dynamo_tpu_torch.disagg`,
`TorchEngine.prefill_remote` / `generate_imported`) against the JAX
package, on the CPU at f32 with the same tiny weights.

The port of tests/test_disagg.py: a prompt prefilled by a port prefill
worker, its KV moved by the block-ID data plane and adopted by a port
decode worker, must give exactly the JAX package's *aggregated* greedy
tokens, for equal and mismatched page sizes and on each lane the CPU has
(colocated and host); both pools settle; a runtime xPyD reconfiguration
and the handler's error paths (a lost prefill worker, a source expired
by TTL, a rejected import) fall back locally and are counted.  The host
lane's frames are the JAX package's: a port source serves a JAX client
and a JAX source serves a port client, and the destination pages equal
what the same transfer gives within one package.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.disagg import DisaggRouter as JaxDisaggRouter
from dynamo_tpu.disagg.transfer import KvTransferClient as JaxClient
from dynamo_tpu.disagg.transfer import KvTransferSource as JaxSource
from dynamo_tpu.disagg.transfer import lookup_layouts as jax_lookup_layouts
from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxEngine
from dynamo_tpu.models import init_params as jax_init_params
from dynamo_tpu.models import tiny_config as jax_tiny_config
from dynamo_tpu.runtime import Context as JaxContext
from dynamo_tpu_torch.disagg import (
    DisaggDecodeHandler,
    DisaggRouter,
    KvTransferClient,
    KvTransferSource,
    PrefillFacade,
    lookup_layouts,
    serve_prefill_worker,
)
from dynamo_tpu_torch.disagg.transfer import LAYOUT_PREFIX
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.llm import ModelDeploymentCard
from dynamo_tpu_torch.models import params_from_jax, tiny_config
from dynamo_tpu_torch.runtime import ControlPlaneServer, Context, DistributedRuntime
from dynamo_tpu_torch.worker import serve_engine

ECFG = dict(page_size=8, num_pages=128, max_num_seqs=4, max_prefill_tokens=128,
            max_model_len=256)
LANES = {"colocated": ("colocated", "host"), "host": ("host",)}
VOCAB = 256  # tiny_config's vocabulary: every prompt stays inside it


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


def req(tokens, max_tokens=8):
    return {"token_ids": tokens,
            "sampling_options": {"temperature": 0.0},
            "stop_conditions": {"max_tokens": max_tokens, "ignore_eos": True}}


async def collect(gen):
    out, reason = [], None
    async for d in gen:
        assert d.get("finish_reason") != "error", d
        out.extend(d.get("token_ids", []))
        reason = d.get("finish_reason") or reason
    return out, reason


async def jax_aggregated(jax_params, prompt, page_size, max_tokens=8):
    agg = jax_engine(jax_params, page_size=page_size)
    try:
        return await collect(agg.generate(req(prompt, max_tokens), JaxContext()))
    finally:
        await agg.shutdown()


def settled(engine) -> bool:
    """Every page of the pool is free or evictable (cached)."""
    pool = engine.pool
    return pool.free_pages + pool.evictable_pages == engine.cfg.usable_pages


async def wait_settled(engine) -> bool:
    """`settled` within a second: a stream's last delta may reach its
    consumer just before the step thread frees the pages behind it, and
    a host-lane source frees on a release frame nobody waits for."""
    for _ in range(50):
        if settled(engine):
            return True
        await asyncio.sleep(0.02)
    return settled(engine)


class Cluster:
    """An embedded control plane, a port prefill worker and a port decode
    handler (tests pick the handler's lanes and router)."""

    def __init__(self, jax_params, prefill_ps, decode_ps, lanes=("colocated", "host"),
                 router=None):
        self.jax_params = jax_params
        self.prefill_ps, self.decode_ps = prefill_ps, decode_ps
        self.lanes = lanes
        self.router = router or DisaggRouter(max_local_prefill_length=16)
        self.prefill_engine = self.prefill_rt = None

    async def __aenter__(self):
        self.control = await ControlPlaneServer().start()
        self.decode_rt = await DistributedRuntime.connect(self.control.address)
        self.decode_engine = torch_engine(self.jax_params, page_size=self.decode_ps)
        self.handler = DisaggDecodeHandler(self.decode_engine, self.decode_rt,
                                           router=self.router)
        self.handler.transfer_client = KvTransferClient(self.decode_engine,
                                                        lanes=self.lanes)
        return self

    async def add_prefill(self, **over):
        self.prefill_rt = await DistributedRuntime.connect(self.control.address)
        self.prefill_engine = torch_engine(self.jax_params, page_size=self.prefill_ps,
                                           **over)
        self.served = await serve_prefill_worker(
            self.prefill_rt, self.prefill_engine, ModelDeploymentCard(name="tiny"))
        return self.served

    async def drop_prefill(self):
        await self.prefill_rt.shutdown(graceful=False)
        await self.prefill_engine.shutdown()
        self.prefill_rt = self.prefill_engine = None

    async def __aexit__(self, *exc):
        await self.handler.shutdown()
        if self.prefill_engine is not None:
            await self.drop_prefill()
        await self.decode_rt.shutdown(graceful=False)
        await self.control.stop()


@pytest.mark.parametrize("lane", sorted(LANES))
@pytest.mark.parametrize("prefill_ps,decode_ps,n_prompt", [
    (8, 8, 80),  # 10 pages each side
    (8, 16, 84),  # 11 source pages, 6 destination pages: aligned on neither
])
async def test_disagg_equals_jax_aggregated(jax_params, lane, prefill_ps,
                                            decode_ps, n_prompt):
    prompt = list(range(1, n_prompt + 1))
    want = await jax_aggregated(jax_params, prompt, decode_ps)
    async with Cluster(jax_params, prefill_ps, decode_ps, LANES[lane]) as c:
        await c.add_prefill()
        got = await collect(c.handler.generate(req(prompt), Context()))
        assert got == want
        h = c.handler
        assert h.kv_transfer_count == 1 and h.prefill_fallback_total == 0
        assert h.kv_transfer_by_lane == {
            "device": int(lane == "colocated"), "ipc": 0,
            "host": int(lane == "host")}
        m = vars(h.metrics())
        assert m["kv_transfer_ms_total"] > 0 and m["kv_transfer_bytes_total"] > 0
        assert m["kv_transfer_device_count"] == int(lane == "colocated")
        # the prefill worker released its held pages
        assert await wait_settled(c.prefill_engine)
        assert c.served.transfer_source.held_pages == 0
        # a second request behind a warm prefill cache: the same tokens
        got2 = await collect(c.handler.generate(req(prompt), Context()))
        assert got2 == want
        assert await wait_settled(c.decode_engine)


async def test_disagg_remote_again_behind_warm_prefill_cache(jax_params):
    """With the decode cache cleared, the second request goes remote again
    and the prefill worker's prefix cache serves its pages."""
    prompt = list(range(3, 83))
    want = await jax_aggregated(jax_params, prompt, 16)
    async with Cluster(jax_params, 8, 16) as c:
        await c.add_prefill()
        assert await collect(c.handler.generate(req(prompt), Context())) == want
        c.decode_engine.clear_kv_blocks()
        before = c.prefill_engine.metrics().prefix_cached_tokens_total
        assert await collect(c.handler.generate(req(prompt), Context())) == want
        assert c.handler.kv_transfer_count == 2
        assert c.prefill_engine.metrics().prefix_cached_tokens_total > before
        assert await wait_settled(c.prefill_engine)


async def test_short_prompt_stays_local(jax_params):
    async with Cluster(jax_params, 8, 8,
                       router=DisaggRouter(max_local_prefill_length=64)) as c:
        # no prefill worker registered at all: local
        got, reason = await collect(
            c.handler.generate(req(list(range(1, 20)), max_tokens=4), Context()))
        assert len(got) == 4 and reason == "length"
        assert c.handler.kv_transfer_count == 0
        assert c.handler.prefill_fallback_total == 0


@pytest.mark.parametrize("max_local,max_depth", [(100, 4), (0, 0), (64, 32)])
def test_disagg_router_decides_as_jax(max_local, max_depth):
    ours = DisaggRouter(max_local_prefill_length=max_local,
                        max_prefill_queue_depth=max_depth)
    theirs = JaxDisaggRouter(max_local_prefill_length=max_local,
                             max_prefill_queue_depth=max_depth)
    for prompt in (0, 1, 50, 64, 65, 100, 101, 200):
        for cached in (0, 16, 150, 200):
            for avail in (True, False):
                for depth in (0, 4, 5, 9, 33):
                    args = (prompt, cached, avail, depth)
                    assert (ours.should_prefill_remotely(*args)
                            == theirs.should_prefill_remotely(*args)), args
    r = DisaggRouter(max_local_prefill_length=100, max_prefill_queue_depth=4)
    assert not r.should_prefill_remotely(50, 0, True)
    assert r.should_prefill_remotely(200, 0, True)
    assert not r.should_prefill_remotely(200, 150, True)  # mostly cached
    assert not r.should_prefill_remotely(200, 0, False)  # no workers
    assert not r.should_prefill_remotely(200, 0, True, prefill_queue_depth=9)


async def test_kv_layout_registered_in_control_plane(jax_params):
    """Prefill workers register their KV layout and data-plane address
    once, lease-scoped; the JAX package's reader reads them as its own."""
    async with Cluster(jax_params, 8, 8) as c:
        await c.add_prefill()
        for read in (lookup_layouts, jax_lookup_layouts):
            layouts = await read(c.prefill_rt, "dynamo", "prefill")
            assert list(layouts) == [str(c.prefill_rt.primary_lease)]
            (entry,) = layouts.values()
            assert entry["layout"] == {"layers": 2, "page_size": 8,
                                       "n_kv_heads": 2, "head_dim": 16,
                                       "dtype": "float32"}
            assert entry["addr"][1] == c.served.transfer_source.port > 0
            assert "cuda_ipc" not in entry  # no card: no ipc lane on offer
        lease = c.prefill_rt.primary_lease
        await c.drop_prefill()
        rows = await c.decode_rt.control.get_prefix(f"{LAYOUT_PREFIX}/dynamo/prefill/")
        assert not rows, f"lease {lease}'s layout outlived it"


async def test_xpyd_runtime_reconfiguration(jax_params):
    """A decode worker starts with no prefill worker (serves locally), one
    joins at runtime and long prompts ride the data plane, then it leaves
    and the decode worker serves locally again."""
    prompt_a = list(range(1, 81))
    prompt_b = [(t * 3) % VOCAB for t in range(50, 130)]
    prompt_c = [(t * 5 + 1) % VOCAB for t in range(1, 81)]
    async with Cluster(jax_params, 8, 8) as c:
        got, _ = await collect(c.handler.generate(req(prompt_a), Context()))
        assert len(got) == 8 and c.handler.kv_transfer_count == 0

        await c.add_prefill()
        deadline = asyncio.get_running_loop().time() + 15
        while c.handler.kv_transfer_count == 0:
            assert asyncio.get_running_loop().time() < deadline
            got, _ = await collect(c.handler.generate(req(prompt_b), Context()))
            assert len(got) == 8
            # an identical prompt would be decode-prefix-cached and local
            prompt_b = [(t + 7) % VOCAB for t in prompt_b]
            await asyncio.sleep(0.2)
        transfers = c.handler.kv_transfer_count

        await c.drop_prefill()  # explicit deregistration
        got, reason = await collect(c.handler.generate(req(prompt_c), Context()))
        assert len(got) == 8 and reason == "length"
        assert c.handler.kv_transfer_count == transfers
        assert c.handler.prefill_fallback_total == 0


class _SlowFetch(KvTransferClient):
    """A client that reaches the data plane only after a delay."""

    delay = 0.0

    async def fetch(self, descriptor, timeout=60.0):
        await asyncio.sleep(self.delay)
        return await super().fetch(descriptor, timeout)


class _InlineFacade(PrefillFacade):
    """A prefill worker answering with the inline KV blob (no data plane)."""

    async def generate(self, request, context):
        yield await self.engine.prefill_remote(request, context)


@pytest.mark.parametrize("fault", ["prefill worker lost", "source expired by TTL",
                                   "import rejected"])
async def test_handler_error_paths_fall_back_locally(jax_params, fault):
    prompt = list(range(5, 85))
    want = await jax_aggregated(jax_params, prompt, 16)
    async with Cluster(jax_params, 8, 16, lanes=("host",)) as c:
        if fault == "prefill worker lost":
            await c.add_prefill()
            # the worker's socket dies; its instance key outlives it
            await c.prefill_rt.service_server.stop()
        elif fault == "source expired by TTL":
            c.handler.transfer_client = _SlowFetch(c.decode_engine, lanes=("host",))
            c.handler.transfer_client.delay = 0.6
            c.prefill_rt = await DistributedRuntime.connect(c.control.address)
            c.prefill_engine = torch_engine(jax_params, page_size=8)
            source = await KvTransferSource(c.prefill_engine, ttl=0.2).start()
            await source.register_layout(c.prefill_rt, "dynamo", "prefill")
            c.served = await serve_engine(
                c.prefill_rt, PrefillFacade(c.prefill_engine, source),
                ModelDeploymentCard(name="tiny", disagg_role="prefill"),
                component="prefill")
            c.served.transfer_source = source
        else:
            # the inline blob of 8-token pages cannot land in 16-token pages
            c.prefill_rt = await DistributedRuntime.connect(c.control.address)
            c.prefill_engine = torch_engine(jax_params, page_size=8)
            await serve_engine(
                c.prefill_rt, _InlineFacade(c.prefill_engine, None),
                ModelDeploymentCard(name="tiny", disagg_role="prefill"),
                component="prefill")
        got = await collect(c.handler.generate(req(prompt), Context()))
        assert got == want
        assert c.handler.prefill_fallback_total == 1
        assert c.handler.kv_transfer_count == 0
        assert await wait_settled(c.decode_engine)
        if fault != "prefill worker lost":
            # the prefill side's pages came back (TTL reap / inline export)
            assert await wait_settled(c.prefill_engine)


async def test_inline_blob_path_equals_jax_aggregated(jax_params):
    """The JAX package's fallback blob (no data plane, equal page sizes):
    `prefill_remote` without a source, then `generate_with_kv`."""
    prompt = list(range(7, 80))
    want = await jax_aggregated(jax_params, prompt, 8)
    p, d = torch_engine(jax_params), torch_engine(jax_params)
    try:
        r = await p.prefill_remote(req(prompt), Context())
        assert r["kv"]["shape"] == [2, 10, 8, 2, 16] and r["kv"]["prompt_len"] == 73
        assert await wait_settled(p)
        got = await collect(d.generate_with_kv(req(prompt), r["token_ids"][0],
                                               r["kv"], Context()))
        assert got == want
    finally:
        await p.shutdown()
        await d.shutdown()


async def _hold(engine, source, prompt, n):
    """`n` remote prefills of `prompt` held by `source` (either package)."""
    out = []
    for _ in range(n):
        r = await engine.prefill_remote(req(prompt, 1),
                                        JaxContext() if isinstance(engine, JaxEngine)
                                        else Context(),
                                        transfer_source=source)
        assert "kv_descriptor" in r, r
        out.append(r["kv_descriptor"])
    return out


async def _pages(engine, pages):
    k, v = await engine.export_pages(pages)
    return [np.asarray(x, np.float32) if not isinstance(x, torch.Tensor)
            else x.float().numpy() for x in (k, v)]


@pytest.mark.parametrize("source_pkg", ["torch", "jax"])
async def test_host_lane_across_packages(jax_params, source_pkg):
    """One package's source serves the other package's client over the
    host lane; the destination pages equal the same transfer within the
    source's own package."""
    prompt = list(range(2, 39))  # 37 tokens: 5 pages of 8, 3 of 16
    nocache = dict(enable_prefix_caching=False, num_pages=64)
    if source_pkg == "torch":
        src_engine = torch_engine(jax_params, **nocache)
        source = await KvTransferSource(src_engine).start()
    else:
        src_engine = jax_engine(jax_params, **nocache)
        source = await JaxSource(src_engine).start()
    dst_t = torch_engine(jax_params, page_size=16, **nocache)
    dst_j = jax_engine(jax_params, page_size=16, **nocache)
    try:
        d_t, d_j = await _hold(src_engine, source, prompt, 2)
        pages_t, st_t = await KvTransferClient(dst_t, lanes=("host",)).fetch(d_t)
        pages_j, st_j = await JaxClient(dst_j, lanes=("host",)).fetch(d_j)
        assert st_t.lane == st_j.lane == "host"
        assert st_t.bytes == st_j.bytes > 0 and st_t.dest_pages == 3
        got_t, got_j = await _pages(dst_t, pages_t), await _pages(dst_j, pages_j)
        for a, b in zip(got_t, got_j):
            np.testing.assert_array_equal(a, b)
        # zeros past the prompt, real KV before it
        k = got_t[0]
        assert not k.reshape(2, 48, 2, 16)[:, 37:].any()
        assert k.reshape(2, 48, 2, 16)[:, :37].any()
        assert await wait_settled(src_engine)
        assert not source._held
    finally:
        await source.stop()
        for e in (src_engine, dst_t, dst_j):
            await e.shutdown()

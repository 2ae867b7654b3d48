"""The device lanes of the port's KV data plane
(`dynamo_tpu_torch.disagg.device_transfer`, `ops/kv_transfer.py`) against
the JAX package, on the CPU.

The port of tests/test_device_transfer.py: the plain re-page (what
`kv_repage` runs on CPU tensors, and what `chip_smoke.py` holds the CUDA
kernel to on the card) equals the JAX package's `device_repage` exactly,
f32 -> f32 and f32 -> bf16, over a sweep of page sizes and prompt
lengths; the colocated, ipc and host lanes leave equal destination pages.
The ipc lane's host logic -- lane choice, the per-lease handle cache and
release ordering -- runs through an injected opener that hands over the
source engine's own pools; the CUDA IPC mapping itself runs only on the
card (`chip_smoke.py` phase 12).
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.disagg.device_transfer import device_repage as jax_device_repage
from dynamo_tpu.models import KVCache as JaxKVCache
from dynamo_tpu.models import init_params as jax_init_params
from dynamo_tpu.models import tiny_config as jax_tiny_config
from dynamo_tpu_torch.disagg import device_transfer as dt
from dynamo_tpu_torch.disagg import (
    DisaggDecodeHandler,
    DisaggRouter,
    KvTransferClient,
    KvTransferSource,
    serve_prefill_worker,
)
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.llm import ModelDeploymentCard
from dynamo_tpu_torch.models import params_from_jax, tiny_config
from dynamo_tpu_torch.ops import kv_transfer as kt
from dynamo_tpu_torch.runtime import ControlPlaneServer, Context, DistributedRuntime

L, KVH, HD = 2, 2, 16


def _pools(rng, pages, ps):
    return [rng.standard_normal((L, pages, ps, KVH, HD)).astype(np.float32)
            for _ in range(2)]


@pytest.mark.parametrize("dst_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("src_ps,dst_ps", [(8, 8), (8, 16), (16, 8), (4, 12),
                                           (16, 32)])
def test_plain_repage_equals_jax_device_repage(src_ps, dst_ps, dst_dtype):
    rng = np.random.default_rng(src_ps * 100 + dst_ps)
    for prompt_len in (1, 27, 32, 33, 47):
        n_src = -(-prompt_len // src_ps)
        n_dst = -(-prompt_len // dst_ps)
        P_s, P_d = n_src + 5, n_dst + 4
        k_host, v_host = _pools(rng, P_s, src_ps)
        src_pages = [int(p) for p in rng.permutation(np.arange(1, P_s))[:n_src]]
        dst_pages = [int(p) for p in rng.permutation(np.arange(1, P_d))[:n_dst]]
        kj, vj = jax_device_repage(
            JaxKVCache(jnp.asarray(k_host), jnp.asarray(v_host)), src_pages,
            src_ps, dst_ps, prompt_len, jnp.dtype(dst_dtype))
        tdt = getattr(torch, dst_dtype)
        dk = torch.full((L, P_d, dst_ps, KVH, HD), 7.0, dtype=tdt)
        dv = torch.full_like(dk, 7.0)
        kt.kv_repage(torch.from_numpy(k_host), torch.from_numpy(v_host), dk, dv,
                     src_pages, dst_pages, prompt_len)
        for got, want in ((dk, kj), (dv, vj)):
            np.testing.assert_array_equal(
                got[:, dst_pages].float().numpy(),
                np.asarray(want[:, :n_dst].astype(jnp.float32)))
        # pages outside the transfer are untouched
        rest = sorted(set(range(P_d)) - set(dst_pages))
        assert (dk[:, rest] == 7.0).all() and (dv[:, rest] == 7.0).all()


def test_covering_pages_pad_with_the_trash_page():
    assert kt.covering_pages([5, 3], 1, 8, 16) == [5, 3]
    assert kt.covering_pages([5, 3, 9], 2, 8, 16) == [5, 3, 9, 0]
    assert kt.covering_pages([5, 3, 9], 3, 16, 8) == [5, 3]
    assert kt.covering_pages([4], 1, 16, 16) == [4]


def test_cuda_wrapper_takes_cuda_tensors_only():
    """No fallback: the kernel's wrapper refuses CPU tensors (the public
    `kv_repage` sends those to the plain version instead)."""
    k = torch.zeros((L, 4, 8, KVH, HD))
    with pytest.raises(ValueError, match="CUDA"):
        kt.kv_repage_cuda(k, k, k.clone(), k.clone(), [1], [2], 5)


def test_local_source_requires_matching_process_token():
    assert dt.local_source({"proc": "someone-else", "transfer_id": "x"}) is None
    assert dt.local_source({"proc": dt.process_token(),
                            "transfer_id": "nope"}) is None


def test_ipc_export_refuses_expandable_segments(monkeypatch):
    monkeypatch.setenv("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    with pytest.raises(ValueError, match="expandable_segments"):
        dt.ipc_export(object())  # refused before the pools are touched


def _card_engine():
    """Just enough of an engine on a card for a source's layout."""
    from types import SimpleNamespace as NS

    return NS(device=torch.device("cuda", 0),
              model_cfg=NS(num_hidden_layers=L, num_key_value_heads=KVH,
                           head_dim_=HD),
              cfg=NS(page_size=16), kv=NS(k=torch.empty(0)))


async def test_source_on_a_card_refuses_to_start_without_the_ipc_lane(monkeypatch):
    """A source on a card that cannot export its pools fails to start: a
    decode worker on that card would otherwise move every prompt through
    the host lane."""
    monkeypatch.setenv("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    source = KvTransferSource(_card_engine())
    with pytest.raises(ValueError, match="expandable_segments"):
        await source.start()
    assert source._server is None and source.port == 0


async def test_descriptor_carries_the_engines_event():
    """The ipc entry of a descriptor carries the handle of the event the
    engine recorded after the prompt's KV writes, not one recorded later."""

    class Event:
        def ipc_handle(self):
            return b"event-handle"

    source = KvTransferSource(_card_engine())
    source.ipc = {"uuid": "card-0", "lease": LEASE}
    with_event = await source.register([3, 4], 20, Event())
    without = await source.register([5], 7)
    assert source.descriptor(with_event)["cuda_ipc"]["event"] == b"event-handle"
    assert source.descriptor(without)["cuda_ipc"]["event"] is None
    assert source.descriptor(with_event)["cuda_ipc"]["pages"] == [3, 4]
    for tid in (with_event, without):
        dt.unregister_local(tid)


# -- lanes over engines ------------------------------------------------------- #


@pytest.fixture(scope="module")
def model():
    jp = jax_init_params(jax_tiny_config(), jax.random.PRNGKey(0),
                         dtype=jnp.float32)
    return params_from_jax(tiny_config(), jax.tree.map(np.asarray, jp),
                           device="cpu")


def make(model, page_size):
    # three prefills of one prompt must be bit-identical: no cache hits
    return TorchEngine(
        tiny_config(), model,
        EngineConfig(page_size=page_size, num_pages=64, max_num_seqs=2,
                     max_prefill_tokens=64, max_model_len=128,
                     enable_prefix_caching=False),
        eos_token_ids=[], device="cpu")


PROMPT = list(range(2, 39))  # 37 tokens
REQ = {"token_ids": PROMPT, "sampling_options": {"temperature": 0.0},
       "stop_conditions": {"max_tokens": 1, "ignore_eos": True}}
LEASE = 4242


class FakeIpc:
    """An injected opener: the "mapping" of a source's pools is the source
    engine's own tensors.  Records what the lane did, in order."""

    def __init__(self, src_engine, log):
        self.src, self.log = src_engine, log

    def open(self, entry, device):
        self.log.append(("open", entry["lease"]))
        return self.src.kv.k, self.src.kv.v

    def event(self, handle, device):
        self.log.append(("event", handle))
        return None


def offer_ipc(source):
    """Make a CPU source offer the ipc lane, as a card would."""
    source.ipc = {"uuid": "card-0", "shape": list(source.engine.kv.k.shape),
                  "stride": list(source.engine.kv.k.stride()), "dtype": "float32",
                  "lease": LEASE, "k": {"share": [0, b"k-handle"]},
                  "v": {"share": [0, b"v-handle"]}}


async def _prefills(engine, source, n):
    out = []
    for _ in range(n):
        r = await engine.prefill_remote(dict(REQ), Context(), transfer_source=source)
        assert "kv_descriptor" in r, r
        out.append(r["kv_descriptor"])
    return out


async def test_lanes_leave_equal_pages(model):
    """Colocated, ipc (injected opener) and host lanes give the same
    destination pages, page-size mismatch included."""
    src = make(model, 8)
    dsts = {lane: make(model, 16) for lane in ("colocated", "ipc", "host")}
    source = await KvTransferSource(src).start()
    offer_ipc(source)
    log = []
    fake = FakeIpc(src, log)
    try:
        descs = await _prefills(src, source, 3)
        assert descs[0]["proc"] == dt.process_token()
        assert descs[0]["cuda_ipc"]["pages"] == source._held[
            descs[0]["transfer_id"]].pages
        got = {}
        for (lane, dst), desc in zip(dsts.items(), descs):
            client = KvTransferClient(
                dst, lanes=("colocated", "ipc", "host") if lane == "colocated"
                else (lane, "host") if lane == "ipc" else ("host",),
                ipc_opener=fake.open, ipc_event_opener=fake.event)
            pages, stats = await client.fetch(desc)
            assert stats.lane == {"colocated": "device"}.get(lane, lane)
            assert stats.dest_pages == len(pages) == 3 and stats.bytes > 0
            got[lane] = await dst.export_pages(pages)
        for lane in ("ipc", "host"):
            for a, b in zip(got[lane], got["colocated"]):
                assert torch.equal(a, b), lane
        k = got["host"][0].reshape(L, 48, KVH, HD)
        assert not k[:, 37:].any() and k[:, :37].abs().sum() > 0
        assert [e[0] for e in log] == ["open", "event"]
        await asyncio.sleep(0.05)
        assert not source._held
    finally:
        await source.stop()
        for e in (src, *dsts.values()):
            await e.shutdown()


async def test_ipc_lane_choice(model):
    """ipc only when the descriptor offers it AND this engine can map it:
    a CPU engine without an opener (no card) takes the host lane, as does
    a descriptor from a source without the lane; with an opener the lane
    is taken."""
    src, dst = make(model, 8), make(model, 8)
    source = await KvTransferSource(src).start()
    try:
        plain = KvTransferClient(dst, lanes=("ipc", "host"))
        assert not plain.ipc.usable(None)
        assert not plain.ipc.usable({"uuid": "card-0"})  # a CPU engine
        (d0,) = await _prefills(src, source, 1)
        assert "cuda_ipc" not in d0
        _, st = await plain.fetch(d0)
        assert st.lane == "host"
        offer_ipc(source)
        d1, d2 = await _prefills(src, source, 2)
        _, st = await plain.fetch(d1)
        assert st.lane == "host"
        injected = KvTransferClient(dst, lanes=("ipc", "host"),
                                    ipc_opener=FakeIpc(src, []).open,
                                    ipc_event_opener=FakeIpc(src, []).event)
        _, st = await injected.fetch(d2)
        assert st.lane == "ipc"
    finally:
        await source.stop()
        await src.shutdown()
        await dst.shutdown()


async def test_ipc_handle_cache_and_release_order(model, monkeypatch):
    """A source lease's pools are mapped once and reused; dropping the
    lease closes the mapping (the next fetch maps again).  Per transfer:
    event wait, re-page, then the release, whose answer comes after the
    source freed the pages."""
    src, dst = make(model, 8), make(model, 16)
    source = await KvTransferSource(src).start()
    offer_ipc(source)
    log = []
    fake = FakeIpc(src, log)
    client = KvTransferClient(dst, lanes=("ipc",), ipc_opener=fake.open,
                              ipc_event_opener=fake.event)
    repage = kt.kv_repage

    def logged_repage(*args, **kw):
        log.append(("repage", len(source._held)))
        return repage(*args, **kw)

    release = client._release_remote

    async def logged_release(desc):
        await release(desc)
        log.append(("released", len(source._held)))

    monkeypatch.setattr(kt, "kv_repage", logged_repage)
    monkeypatch.setattr(client, "_release_remote", logged_release)
    try:
        descs = await _prefills(src, source, 3)
        for d in descs[:2]:
            await client.fetch(d)
        assert client.ipc.opened == 1 and client.ipc.mapped == 1
        assert client.ipc.drop(LEASE + 1) == 0
        assert client.ipc.drop(LEASE) == 1 and client.ipc.mapped == 0
        await client.fetch(descs[2])
        assert client.ipc.opened == 2
        assert log == [("open", LEASE), ("event", None), ("repage", 3),
                       ("released", 2), ("event", None), ("repage", 2),
                       ("released", 1), ("open", LEASE), ("event", None),
                       ("repage", 1), ("released", 0)]
    finally:
        await source.stop()
        await src.shutdown()
        await dst.shutdown()


async def test_ipc_failure_raises_frees_and_releases(model):
    """A failed mapping raises out of the fetch (the handler prefills
    locally); it never drops to the host lane, and both sides' pages come
    back."""
    src, dst = make(model, 8), make(model, 8)
    source = await KvTransferSource(src).start()
    offer_ipc(source)

    def broken(entry, device):
        raise RuntimeError("cudaIpcOpenMemHandle failed")

    client = KvTransferClient(dst, ipc_opener=broken)
    try:
        (d,) = await _prefills(src, source, 1)
        d = {**d, "proc": "another-process"}  # not colocated
        with pytest.raises(RuntimeError, match="cudaIpcOpenMemHandle"):
            await client.fetch(d)
        assert dst.pool.free_pages == dst.cfg.usable_pages
        assert not source._held
        assert src.pool.free_pages == src.cfg.usable_pages
    finally:
        await source.stop()
        await src.shutdown()
        await dst.shutdown()


async def test_disagg_handler_counts_device_lane():
    """The whole disagg flow in one process: the handler's fetch takes
    the colocated lane and its counters say so."""
    from dynamo_tpu_torch.testing import tiny_tokenizer

    tok = tiny_tokenizer()
    jp = jax_init_params(jax_tiny_config(vocab_size=tok.vocab_size),
                         jax.random.PRNGKey(1), dtype=jnp.float32)
    cfg = tiny_config(vocab_size=tok.vocab_size)
    model = params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")

    def engine(page_size):
        return TorchEngine(cfg, model,
                           EngineConfig(page_size=page_size, num_pages=128,
                                        max_num_seqs=4, max_prefill_tokens=128,
                                        max_model_len=256),
                           eos_token_ids=[], device="cpu")

    control = await ControlPlaneServer().start()
    rt_p = await DistributedRuntime.connect(control.address)
    rt_d = await DistributedRuntime.connect(control.address)
    prefill_engine, decode_engine = engine(8), engine(16)
    mdc = ModelDeploymentCard(name="m", tokenizer_json=tok.to_json_str())
    await serve_prefill_worker(rt_p, prefill_engine, mdc)
    handler = DisaggDecodeHandler(decode_engine, rt_d,
                                  router=DisaggRouter(max_local_prefill_length=8))
    try:
        req = {"token_ids": list(range(3, 70)),
               "sampling_options": {"temperature": 0.0},
               "stop_conditions": {"max_tokens": 4, "ignore_eos": True}}
        toks = []
        async for out in handler.generate(req, Context()):
            assert out.get("finish_reason") != "error", out
            toks += out["token_ids"]
        assert len(toks) == 4
        assert handler.kv_transfer_count == 1
        assert handler.kv_transfer_device_count == 1  # same process
        m = vars(handler.metrics())
        assert m["kv_transfer_device_count"] == m["kv_transfer_count"] == 1
        assert m["kv_transfer_ipc_count"] == m["kv_transfer_host_count"] == 0
        assert m["prefill_fallback_total"] == 0
    finally:
        await handler.shutdown()
        await prefill_engine.shutdown()
        await rt_d.shutdown(graceful=False)
        await rt_p.shutdown(graceful=False)
        await control.stop()

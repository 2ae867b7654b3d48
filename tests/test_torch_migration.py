"""Request migration in the port (`llm/migration.py`, wired into
`ModelEntry.generate`) against the JAX package's, on the CPU — the mirror
of the JAX package's `tests/test_resilience.py` migration cases with port
workers:

- a worker killed mid-stream: the stream goes on at the other worker and
  its greedy tokens equal an undisturbed run's, both through
  `migrating_stream` directly and through the port's HTTP frontend, where
  `dynamo_frontend_migrations_total` counts the migration;
- the migration limit exhausted: the same error chunk as JAX's;
- backoff pacing and telemetry: no-progress retries paced, post-progress
  failures retried at once, the events on the callback; `_backoff_s`
  equal to JAX's on the same seeded RNGs.
"""

import asyncio
import json
import random

import aiohttp
import pytest
import torch

from dynamo_tpu.llm import migration as jax_migration
from dynamo_tpu.runtime import Context as JaxContext
from dynamo_tpu.runtime.transport.service import RemoteStreamError as JaxRemoteStreamError
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.frontend import (
    FrontendMetrics,
    HttpService,
    ModelManager,
    ModelWatcher,
)
from dynamo_tpu_torch.llm import ModelDeploymentCard
from dynamo_tpu_torch.llm import migration
from dynamo_tpu_torch.models import init_params, tiny_config
from dynamo_tpu_torch.runtime import Context, DistributedRuntime
from dynamo_tpu_torch.runtime.transport.service import RemoteStreamError
from dynamo_tpu_torch.testing import tiny_tokenizer
from dynamo_tpu_torch.worker import serve_engine

T = 60  # seconds, every network wait
MODEL = "tiny-chat"
ECFG = dict(page_size=8, num_pages=64, max_num_seqs=4, max_prefill_tokens=64,
            max_model_len=256)


def req(tokens, max_tokens, greedy=False):
    return {"token_ids": tokens,
            "sampling_options": {"temperature": 0.0} if greedy else {"seed": 3},
            "stop_conditions": {"max_tokens": max_tokens, "ignore_eos": True}}


@pytest.mark.parametrize("attempt,base,cap", [
    (1, 50, 400), (2, 50, 400), (5, 50, 400), (9, 50, 400), (3, 0, 400),
    (3, 500, 100), (1, 1, 1)])
def test_backoff_matches_jax(attempt, base, cap):
    got = [migration._backoff_s(attempt, base, cap, random.Random(s))
           for s in range(8)]
    want = [jax_migration._backoff_s(attempt, base, cap, random.Random(s))
            for s in range(8)]
    assert got == want


def _dead(exc):
    async def factory(request, context):
        raise exc("worker gone")
        yield  # pragma: no cover
    return factory


async def test_migration_limit_exhausted_as_jax():
    outs = []
    for mod, ctx, exc in ((jax_migration, JaxContext, JaxRemoteStreamError),
                          (migration, Context, RemoteStreamError)):
        events = []
        out = [o async for o in mod.migrating_stream(
            req([1], 5), ctx(), _dead(exc), migration_limit=2, backoff_ms=0,
            on_migration=events.append)]
        outs.append((out, events))
    assert outs[1] == outs[0]
    assert outs[1][0][-1]["finish_reason"] == "error"
    assert outs[1][1] == ["migrated", "migrated", "exhausted"]


async def test_migration_backoff_pacing_and_telemetry():
    events = []
    loop = asyncio.get_running_loop()
    t0 = loop.time()
    out = [o async for o in migration.migrating_stream(
        req([1], 5), Context(), _dead(RemoteStreamError), migration_limit=2,
        backoff_ms=40, backoff_max_ms=80, on_migration=events.append,
        _rng=random.Random(1))]
    assert out[-1]["finish_reason"] == "error"
    assert events == ["migrated", "migrated", "exhausted"]
    # two no-progress retries: at least half of 40 ms + half of 80 ms
    assert loop.time() - t0 >= 0.055

    calls = {"n": 0}

    async def flaky(request, context):
        calls["n"] += 1
        yield {"token_ids": [calls["n"]]}
        raise RemoteStreamError("died after progress")

    events.clear()
    t0 = loop.time()
    out = [o async for o in migration.migrating_stream(
        req([1], 3), Context(), flaky, migration_limit=1, backoff_ms=200,
        backoff_max_ms=200, on_migration=events.append)]
    # each failure after progress is a fresh incident: no exhaustion
    # despite limit 1, and no 200 ms pauses
    assert [t for o in out for t in o.get("token_ids", [])] == [1, 2, 3]
    assert out[-1]["finish_reason"] == "length"
    assert "exhausted" not in events
    assert loop.time() - t0 < 0.15
    # every worker delta reaches the client as the worker sent it
    assert out[:3] == [{"token_ids": [n]} for n in (1, 2, 3)]


class _Paced:
    """A port engine whose stream pauses after each delta, so a worker can
    be killed while its stream is live; `serving` counts its open
    streams."""

    def __init__(self, engine, delay=0.02):
        self.engine = engine
        self.delay = delay
        self.serving = 0

    async def generate(self, request, context=None):
        self.serving += 1
        try:
            async for out in self.engine.generate(request, context):
                yield out
                await asyncio.sleep(self.delay)
        finally:
            self.serving -= 1

    async def shutdown(self):
        await self.engine.shutdown()


class _Workers:
    """Two port workers (own runtimes, one control plane, the same tiny
    f32 weights) serving one model."""

    async def start(self):
        tok = tiny_tokenizer()
        cfg = tiny_config(vocab_size=tok.vocab_size)
        model = init_params(cfg, torch.Generator().manual_seed(5),
                            torch.float32, device="cpu")
        self.control_rt = await DistributedRuntime.detached()
        addr = self.control_rt.control_address
        self.rts, self.engines = [], []
        for _ in range(2):
            rt = await DistributedRuntime.connect(addr)
            eng = _Paced(TorchEngine(cfg, model, EngineConfig(**ECFG),
                                     eos_token_ids=[], device="cpu"))
            await serve_engine(rt, eng, ModelDeploymentCard(
                name=MODEL, tokenizer_json=tok.to_json_str()),
                publish_kv_events=False)
            self.rts.append(rt)
            self.engines.append(eng)
        self.front = await DistributedRuntime.connect(addr)
        return self

    async def stop(self):
        for rt in (self.front, *self.rts, self.control_rt):
            await rt.shutdown(graceful=False)
        for e in self.engines:
            await e.shutdown()


async def test_migration_on_worker_death_keeps_greedy_tokens():
    """Kill the serving worker mid-stream; the stream continues on the
    other worker with no client-visible error and the tokens of an
    undisturbed greedy run."""
    w = await _Workers().start()
    ep = w.front.namespace("dynamo").component("backend").endpoint("generate")
    client = await ep.client().start()
    try:
        insts = await asyncio.wait_for(client.wait_for_instances(), T)
        assert len(insts) == 2
        prompt = list(range(5, 45))
        undisturbed = [t async for o in w.engines[1].engine.generate(
            req(prompt, 32, greedy=True)) for t in o["token_ids"]]
        first = {"n": 0, "id": None}

        def factory(request, context):
            first["n"] += 1
            if first["n"] == 1:
                first["id"] = insts[0].instance_id
                return client.direct(request, first["id"], context)
            return client.round_robin(request, context)

        tokens, killed = [], None
        async for out in migration.migrating_stream(
                req(prompt, 32, greedy=True), Context(), factory,
                migration_limit=3, backoff_ms=0):
            assert out.get("finish_reason") != "error", out
            tokens += out.get("token_ids", [])
            if len(tokens) >= 3 and killed is None:
                killed = next(i for i, e in enumerate(w.engines) if e.serving)
                await w.rts[killed].shutdown(graceful=False)
        assert first["n"] >= 2  # actually migrated
        assert tokens == undisturbed
    finally:
        await client.stop()
        await w.stop()


async def test_frontend_migrates_a_stream_and_counts_it():
    """Through the port's HTTP frontend (SSE): the worker serving a greedy
    stream dies after a few tokens; the client gets the whole text of an
    undisturbed run and the frontend's /metrics counts one migration."""
    w = await _Workers().start()
    metrics = FrontendMetrics()
    watcher = await ModelWatcher(w.front, ModelManager(), metrics=metrics).start()
    await asyncio.wait_for(watcher.wait_for_model(MODEL), T)
    entry = watcher.manager.get(MODEL)
    for _ in range(200):  # both workers' cards discovered
        if len(entry.instances) == 2:
            break
        await asyncio.sleep(0.02)
    http = await HttpService(watcher.manager, host="127.0.0.1", port=0,
                             metrics=metrics).start()
    base = f"http://127.0.0.1:{http.port}"
    body = {"model": MODEL, "prompt": list(range(7, 47)), "max_tokens": 32,
            "temperature": 0, "nvext": {"ignore_eos": True}}
    try:
        async with aiohttp.ClientSession() as s:
            async def text(stream, kill=False):
                async with s.post(base + "/v1/completions",
                                  json={**body, "stream": stream}) as r:
                    assert r.status == 200
                    if not stream:
                        return (await r.json())["choices"][0]["text"], None
                    pieces, killed = [], None
                    async for line in r.content:
                        line = line.decode().strip()
                        if not line.startswith("data: ") or line == "data: [DONE]":
                            continue
                        chunk = json.loads(line[6:])
                        assert "error" not in chunk, chunk
                        pieces.append(chunk["choices"][0]["text"])
                        if kill and len(pieces) == 4:
                            killed = next(i for i, e in enumerate(w.engines)
                                          if e.serving)
                            await w.rts[killed].shutdown(graceful=False)
                    return "".join(pieces), killed

            want, _ = await asyncio.wait_for(text(False), T)
            got, killed = await asyncio.wait_for(text(True, kill=True), T)
            assert killed is not None and got == want
            async with s.get(base + "/metrics") as r:
                exposition = await r.text()
            assert (f'dynamo_frontend_migrations_total{{model="{MODEL}"}} 1.0'
                    in exposition)
            # a later request is served by the survivor
            again, _ = await asyncio.wait_for(text(False), T)
            assert again == want
    finally:
        await http.stop()
        await watcher.stop()
        await w.stop()

"""The port's serving stack over HTTP on the CPU, against the JAX stack.

Each stack serves the tiny model (f32, the same weights: the JAX
`init_params` tree moved across with `params_from_jax`; the same tiny
tokenizer) through its own control plane, worker, model watcher and
OpenAI frontend, and both answer the same requests: the same text,
finish reasons and usage for greedy and seeded chat and completions,
unary and SSE; the same status and error type for malformed requests.
An interop case routes the JAX frontend to a port worker over the JAX
control plane.  Every network wait has its own timeout."""

import asyncio
import json

import aiohttp
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxEngine
from dynamo_tpu.frontend import HttpService as JaxHttpService
from dynamo_tpu.frontend import ModelManager as JaxModelManager
from dynamo_tpu.frontend import ModelWatcher as JaxModelWatcher
from dynamo_tpu.llm import ModelDeploymentCard as JaxCard
from dynamo_tpu.models import init_params as jax_init_params
from dynamo_tpu.models import tiny_config as jax_tiny_config
from dynamo_tpu.runtime import ControlPlaneServer as JaxControlPlane
from dynamo_tpu.runtime import DistributedRuntime as JaxRuntime
from dynamo_tpu.testing import tiny_tokenizer as jax_tiny_tokenizer
from dynamo_tpu.worker import serve_engine as jax_serve_engine
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.frontend import HttpService, ModelManager, ModelWatcher
from dynamo_tpu_torch.llm import ModelDeploymentCard
from dynamo_tpu_torch.models import params_from_jax, tiny_config
from dynamo_tpu_torch.runtime import DistributedRuntime
from dynamo_tpu_torch.testing import tiny_tokenizer
from dynamo_tpu_torch.worker import serve_engine

T = 60  # seconds, every network wait
ECFG = dict(page_size=8, num_pages=128, max_num_seqs=4, max_prefill_tokens=64,
            max_model_len=256)
MODEL = "tiny-chat"


@pytest.fixture(scope="module")
def jax_params():
    tok = jax_tiny_tokenizer()
    return jax_init_params(jax_tiny_config(vocab_size=tok.vocab_size),
                           jax.random.PRNGKey(0), dtype=jnp.float32)


def _jax_engine(params):
    tok = jax_tiny_tokenizer()
    return JaxEngine(jax_tiny_config(vocab_size=tok.vocab_size), params,
                     JaxEngineConfig(**ECFG), eos_token_ids=list(tok.eos_token_ids),
                     kv_dtype=jnp.float32)


def _port_engine(params):
    tok = tiny_tokenizer()
    cfg = tiny_config(vocab_size=tok.vocab_size)
    model = params_from_jax(cfg, jax.tree.map(np.asarray, params), device="cpu")
    return TorchEngine(cfg, model, EngineConfig(**ECFG),
                       eos_token_ids=list(tok.eos_token_ids), device="cpu")


def _port_card(name=MODEL):
    tok = tiny_tokenizer()
    return ModelDeploymentCard(name=name, tokenizer_json=tok.to_json_str(),
                               eos_token_ids=list(tok.eos_token_ids))


class _Stack:
    """Control plane + worker + watcher + frontend of one package."""

    async def start_jax(self, params):
        self.control = await JaxControlPlane().start()
        self.worker_rt = await JaxRuntime.connect(self.control.address)
        self.engine = _jax_engine(params)
        tok = jax_tiny_tokenizer()
        await jax_serve_engine(self.worker_rt, self.engine, JaxCard(
            name=MODEL, tokenizer_json=tok.to_json_str(),
            eos_token_ids=list(tok.eos_token_ids)))
        self.front_rt = await JaxRuntime.connect(self.control.address)
        self.watcher = await JaxModelWatcher(self.front_rt, JaxModelManager()).start()
        await asyncio.wait_for(self.watcher.wait_for_model(MODEL), T)
        self.http = await JaxHttpService(self.watcher.manager, host="127.0.0.1",
                                         port=0).start()
        return self

    async def start_port(self, params):
        self.control = None
        self.worker_rt = await DistributedRuntime.detached()
        self.engine = _port_engine(params)
        await serve_engine(self.worker_rt, self.engine, _port_card())
        self.front_rt = await DistributedRuntime.connect(self.worker_rt.control_address)
        self.watcher = await ModelWatcher(self.front_rt, ModelManager()).start()
        await asyncio.wait_for(self.watcher.wait_for_model(MODEL), T)
        self.http = await HttpService(self.watcher.manager, host="127.0.0.1",
                                      port=0).start()
        return self

    @property
    def base(self):
        return f"http://127.0.0.1:{self.http.port}"

    async def stop(self):
        await self.http.stop()
        await self.watcher.stop()
        await self.engine.shutdown()
        await self.front_rt.shutdown(graceful=False)
        await self.worker_rt.shutdown(graceful=False)
        if self.control is not None:
            await self.control.stop()


async def post(session, base, path, body, raw=None):
    """(status, parsed JSON or SSE chunk list)."""
    async def go():
        kw = {"data": raw} if raw is not None else {"json": body}
        async with session.post(base + path, **kw) as r:
            if r.headers.get("Content-Type", "").startswith("text/event-stream"):
                chunks = []
                async for line in r.content:
                    line = line.decode().strip()
                    if line.startswith("data: ") and line != "data: [DONE]":
                        chunks.append(json.loads(line[6:]))
                return r.status, chunks
            return r.status, await r.json(content_type=None)
    return await asyncio.wait_for(go(), T)


def summary(kind, status, out):
    """What must agree between the stacks: per choice (text, finish),
    and usage for unary answers."""
    if isinstance(out, list):  # SSE chunks
        texts, finish = {}, {}
        for c in out:
            for ch in c.get("choices", []):
                i = ch["index"]
                piece = (ch["delta"].get("content", "") if kind == "chat"
                         else ch.get("text", ""))
                texts[i] = texts.get(i, "") + piece
                finish[i] = ch.get("finish_reason") or finish.get(i)
        return status, sorted((i, texts[i], finish[i]) for i in texts), None
    return status, sorted(
        (c["index"], c["message"]["content"] if kind == "chat" else c["text"],
         c["finish_reason"]) for c in out["choices"]), out["usage"]


CHAT = [{"role": "user", "content": "hello world"}]
CASES = {
    "chat_greedy": ("chat", {"messages": CHAT, "max_tokens": 8, "temperature": 0,
                             "nvext": {"ignore_eos": True}}),
    "chat_seeded_n2": ("chat", {"messages": CHAT, "max_tokens": 8, "temperature": 0.8,
                                "seed": 11, "n": 2, "nvext": {"ignore_eos": True}}),
    "chat_eos_allowed": ("chat", {"messages": CHAT, "max_tokens": 24,
                                  "temperature": 0.9, "seed": 4}),
    "completion_greedy_text": ("completion", {"prompt": "the quick brown",
                                              "max_tokens": 6, "temperature": 0,
                                              "nvext": {"ignore_eos": True}}),
    "completion_tokens_seeded": ("completion", {"prompt": [5, 9, 17, 23, 4, 11],
                                                "max_tokens": 7, "temperature": 1.0,
                                                "top_p": 0.9, "seed": 3,
                                                "nvext": {"ignore_eos": True}}),
    "completion_stop_string": ("completion", {"prompt": "hello", "max_tokens": 16,
                                              "temperature": 0, "stop": ["_|", "@"],
                                              "nvext": {"ignore_eos": True}}),
}
PATHS = {"chat": "/v1/chat/completions", "completion": "/v1/completions"}


async def test_port_http_matches_jax_http(jax_params):
    jax_stack = await _Stack().start_jax(jax_params)
    port_stack = await _Stack().start_port(jax_params)
    try:
        async with aiohttp.ClientSession() as s:
            for name, (kind, body) in CASES.items():
                body = {"model": MODEL, **body}
                for stream in (False, True):
                    got = [summary(kind, *await post(s, st.base, PATHS[kind],
                                                     {**body, "stream": stream}))
                           for st in (jax_stack, port_stack)]
                    assert got[1] == got[0], (name, stream)
                    assert got[1][0] == 200, (name, stream)
                    if stream:  # SSE concatenation == the unary text
                        assert got[1][1] == unary[1], name
                    else:
                        unary = got[1]
                        assert got[1][2]["completion_tokens"] > 0, name
            # logprobs: same tokens and shapes, values to f32 precision
            body = {"model": MODEL, "messages": CHAT, "max_tokens": 4,
                    "temperature": 0, "logprobs": True, "top_logprobs": 2}
            lp = [(await post(s, st.base, PATHS["chat"], body))[1]["choices"][0]
                  ["logprobs"]["content"] for st in (jax_stack, port_stack)]
            assert [c["token"] for c in lp[1]] == [c["token"] for c in lp[0]]
            np.testing.assert_allclose([c["logprob"] for c in lp[1]],
                                       [c["logprob"] for c in lp[0]], atol=1e-4)
            assert [[t["token"] for t in c["top_logprobs"]] for c in lp[1]] == [
                [t["token"] for t in c["top_logprobs"]] for c in lp[0]]
            # the port's other routes answer
            for path in ("/v1/models", "/health", "/live", "/metrics"):
                async with s.get(port_stack.base + path) as r:
                    assert r.status == 200, path
                    text = await asyncio.wait_for(r.text(), T)
            assert "dynamo_frontend_time_to_first_token_seconds_bucket" in text
            assert 'dynamo_frontend_requests_total{model="tiny-chat",kind="chat",status="200"}' in text
    finally:
        await port_stack.stop()
        await jax_stack.stop()


MALFORMED = [
    ("invalid JSON", "/v1/chat/completions", None, b"{not json"),
    ("unknown model", "/v1/completions", {"model": "nope", "prompt": "x"}, None),
    ("temperature out of range", "/v1/chat/completions",
     {"model": MODEL, "messages": CHAT, "temperature": 5}, None),
    ("no messages", "/v1/chat/completions", {"model": MODEL, "messages": []}, None),
    ("too many stops", "/v1/completions",
     {"model": MODEL, "prompt": "x", "stop": ["a", "b", "c", "d", "e"]}, None),
]


async def test_port_errors_match_jax(jax_params):
    jax_stack = await _Stack().start_jax(jax_params)
    port_stack = await _Stack().start_port(jax_params)
    try:
        async with aiohttp.ClientSession() as s:
            for name, path, body, raw in MALFORMED:
                got = []
                for st in (jax_stack, port_stack):
                    status, out = await post(s, st.base, path, body, raw=raw)
                    got.append((status, out["error"]["type"], out["error"]["message"]))
                assert got[1] == got[0], name
                assert got[1][0] in (400, 404), name
    finally:
        await port_stack.stop()
        await jax_stack.stop()


async def test_jax_frontend_routes_to_port_worker(jax_params):
    """Interop: one JAX control plane and JAX frontend; the JAX worker
    serves "tiny-chat", a port worker (port runtime, transport, codec and
    card) serves "tiny-chat-port" with the same weights.  Both give the
    same text."""
    jax_stack = await _Stack().start_jax(jax_params)
    port_rt = await DistributedRuntime.connect(jax_stack.control.address)
    port_engine = _port_engine(jax_params)
    try:
        await serve_engine(port_rt, port_engine, _port_card("tiny-chat-port"))
        await asyncio.wait_for(jax_stack.watcher.wait_for_model("tiny-chat-port"), T)
        async with aiohttp.ClientSession() as s:
            for kind, body in (CASES["chat_greedy"], CASES["completion_tokens_seeded"]):
                got = []
                for model in (MODEL, "tiny-chat-port"):
                    for stream in (False, True):
                        got.append(summary(kind, *await post(
                            s, jax_stack.base, PATHS[kind],
                            {**body, "model": model, "stream": stream}))[:2])
                assert got[0][0] == 200 and got[0][1][0][1]
                assert got == [got[0]] * 4, kind
    finally:
        await port_rt.shutdown(graceful=False)
        await port_engine.shutdown()
        await jax_stack.stop()

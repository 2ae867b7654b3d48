"""OpenAI-compatible HTTP service on the port's own HTTP/1.1 server.

The port's copy of the JAX package's `frontend/openai_http.py`:

- POST /v1/chat/completions, /v1/completions — SSE streaming and unary,
  n>1 choices, OpenAI logprobs/top_logprobs shapes, each stream migrated
  to another worker when its worker dies (`ModelEntry.generate`);
- POST /v1/embeddings — mean-pooled, unit-normalised vectors;
- GET  /v1/models, /health, /live, /metrics (Prometheus text);
- POST /clear_kv_blocks — broadcast cache clear to workers.

Request validation and error bodies are the JAX frontend's, so the same
bad request gets the same status and ``error.type``.  /v1/responses
answers 501 (not ported yet), as do output parsers,
overload shedding's batch probe, SLO windows, waterfalls, tracing spans,
audit and the step-event ring (`ROADMAP.md` lists them).  Like the JAX
frontend, `stream_options` is not read: a stream carries no usage chunk.
Client disconnects kill the request context so workers stop generating.
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
import uuid
from typing import Any, Dict, Optional

from ..llm import RequestError
from ..runtime import Context
from ..runtime.transport.service import RemoteStreamError, ServiceUnavailable
from .egress import CONTENT_SENTINEL, ChunkTemplate, StreamEgress
from .http_server import HttpServer, Request, Response, StreamResponse, json_response
from .metrics import FrontendMetrics
from .service import ModelManager

logger = logging.getLogger(__name__)

# idle SSE connections get a comment ping this often (seconds), measured
# from the last bytes actually WRITTEN to the connection
SSE_KEEPALIVE_S = 10.0
# a request body's limit: one 32 MB medium as base64, with room for the rest
MAX_REQUEST_BYTES = 48 << 20

# max queue items drained into one write (bounds frame batch size and
# keeps a badly backed-up stream from starving its siblings)
_MAX_BURST = 256

# queue sentinel the rearming keepalive timer drops in when the
# time-since-last-write deadline passes (never a real delta tuple)
_KEEPALIVE = object()


def _env_bool(name: str, default: bool = False) -> bool:
    import os

    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    return raw.lower() in ("1", "true", "yes", "on")


class HttpService:
    def __init__(self, manager: ModelManager, host: str = "0.0.0.0",
                 port: int = 8000, metrics: Optional[FrontendMetrics] = None,
                 sse_coalesce: Optional[bool] = None):
        self.manager = manager
        self.metrics = metrics or FrontendMetrics()
        # merge same-choice deltas under backpressure (frontend/egress.py)
        self.sse_coalesce = (_env_bool("DYN_TPU_SSE_COALESCE")
                             if sse_coalesce is None else bool(sse_coalesce))
        self.sse_coalesce_max = 64
        self.host = host
        self.port = port
        routes = {
            ("POST", "/v1/chat/completions"): self.chat_completions,
            ("POST", "/v1/completions"): self.completions,
            ("POST", "/v1/embeddings"): self.embeddings,
            ("POST", "/v1/responses"): self.not_ported,
            ("GET", "/v1/models"): self.list_models,
            ("GET", "/health"): self.health,
            ("GET", "/live"): self.live,
            ("GET", "/metrics"): self.prometheus,
            ("POST", "/clear_kv_blocks"): self.clear_kv_blocks,
        }
        # vision chats carry their media inline as data: URIs, up to the
        # 32 MB a medium may hold once decoded from base64
        self._server = HttpServer(routes, host, port, max_body=MAX_REQUEST_BYTES)

    # -- lifecycle ----------------------------------------------------------- #

    async def start(self) -> "HttpService":
        await self._server.start()
        self.port = self._server.port
        logger.info("http service on %s:%d", self.host, self.port)
        return self

    async def stop(self) -> None:
        await self._server.stop()

    # -- handlers ------------------------------------------------------------ #

    async def health(self, request: Request) -> Response:
        return json_response({"status": "healthy", "models": self.manager.names()})

    async def live(self, request: Request) -> Response:
        return json_response({"status": "live"})

    async def prometheus(self, request: Request) -> Response:
        return Response(self.metrics.exposition(),
                        content_type="text/plain; version=0.0.4; charset=utf-8")

    async def not_ported(self, request: Request) -> Response:
        return _error_response(
            501, f"{request.path} is not ported to dynamo_tpu_torch yet",
            code="not_implemented")

    async def list_models(self, request: Request) -> Response:
        now = int(time.time())
        data = [
            {"id": name, "object": "model", "created": now, "owned_by": "dynamo-tpu"}
            for name in self.manager.names()
        ]
        return json_response({"object": "list", "data": data})

    async def clear_kv_blocks(self, request: Request) -> Response:
        results = {}
        for name in self.manager.names():
            entry = self.manager.get(name)
            try:
                async for out in entry.route(
                    {"control": "clear_kv_blocks"}, Context()
                ):
                    results[name] = out
                    break
            except (ServiceUnavailable, RemoteStreamError) as e:
                results[name] = {"error": str(e)}
        return json_response(results)

    async def chat_completions(self, request: Request):
        return await self._serve(request, kind="chat")

    async def completions(self, request: Request):
        return await self._serve(request, kind="completion")

    async def embeddings(self, request: Request) -> Response:
        """OpenAI /v1/embeddings (reference openai.rs).  Routed like a
        generate request, without migration: in ``kv`` mode by load alone,
        as the request carries no ``token_ids``."""
        try:
            body = await request.json()
        except json.JSONDecodeError:
            return _error_response(400, "invalid JSON body")
        model_name = body.get("model", "")
        entry = self.manager.get(model_name)
        if entry is None:
            self.metrics.requests.labels(model_name or "?", "embedding", "404").inc()
            return _error_response(
                404, f"model '{model_name}' not found", code="model_not_found"
            )
        if not entry.mdc.supports("embedding"):
            return _error_response(
                400, f"model '{model_name}' does not support embeddings"
            )
        try:
            preq = await asyncio.get_running_loop().run_in_executor(
                None, entry.preprocessor.preprocess_embedding, body
            )
        except RequestError as e:
            self.metrics.requests.labels(model_name, "embedding", "400").inc()
            return _error_response(400, str(e))
        try:
            result = None
            async for out in entry.route(preq, Context()):
                result = out
                break
        except ServiceUnavailable as e:
            self.metrics.requests.labels(model_name, "embedding", "503").inc()
            return _error_response(503, str(e))
        except RemoteStreamError as e:
            self.metrics.requests.labels(model_name, "embedding", "502").inc()
            return _error_response(502, str(e))
        if not result or result.get("error"):
            self.metrics.requests.labels(model_name, "embedding", "500").inc()
            return _error_response(
                500, (result or {}).get("error", "embedding failed")
            )
        self.metrics.requests.labels(model_name, "embedding", "200").inc()
        data = [
            {"object": "embedding", "index": i, "embedding": vec}
            for i, vec in enumerate(result.get("embeddings", []))
        ]
        ptoks = int(result.get("prompt_tokens", 0))
        return json_response({
            "object": "list",
            "data": data,
            "model": model_name,
            "usage": {"prompt_tokens": ptoks, "total_tokens": ptoks},
        })

    # -- core serving path --------------------------------------------------- #

    async def _serve(self, request: Request, kind: str):
        t0 = time.monotonic()
        try:
            body = await request.json()
        except json.JSONDecodeError:
            return _error_response(400, "invalid JSON body")
        model_name = body.get("model", "")
        entry = self.manager.get(model_name)
        if entry is None:
            self.metrics.requests.labels(model_name or "?", kind, "404").inc()
            return _error_response(
                404, f"model '{model_name}' not found", code="model_not_found"
            )
        required = "chat" if kind == "chat" else "completions"
        if not entry.mdc.supports(required):
            return _error_response(
                400, f"model '{model_name}' does not support {required}"
            )
        pre = (entry.preprocessor.preprocess_chat if kind == "chat"
               else entry.preprocessor.preprocess_completion)
        try:
            # template render + tokenize off the event loop
            preprocessed = await asyncio.get_running_loop().run_in_executor(
                None, pre, body)
        except RequestError as e:
            self.metrics.requests.labels(model_name, kind, "400").inc()
            return _error_response(400, str(e))

        n = preprocessed["sampling_options"].get("n", 1)
        rid = ("chatcmpl-" if kind == "chat" else "cmpl-") + uuid.uuid4().hex[:24]
        self.metrics.inflight.labels(model_name).inc()
        try:
            if body.get("stream", False):
                return await self._stream_response(
                    request, entry, preprocessed, n, rid, kind, model_name, t0
                )
            return await self._unary_response(
                entry, preprocessed, n, rid, kind, model_name, t0
            )
        finally:
            self.metrics.inflight.labels(model_name).dec()

    def _choice_requests(self, preprocessed, n):
        """n independent engine requests; explicit seeds offset per choice
        so n>1 with a seed still yields distinct-but-reproducible choices."""
        out = []
        for i in range(n):
            preq = {
                **preprocessed,
                "sampling_options": dict(preprocessed["sampling_options"]),
            }
            seed = preq["sampling_options"].get("seed")
            if seed is not None and i:
                preq["sampling_options"]["seed"] = seed + i
            out.append(preq)
        return out

    async def _stream_response(
        self, request, entry, preprocessed, n, rid, kind, model_name, t0
    ) -> StreamResponse:
        ntokens = 0
        status = "200"
        contexts = [Context() for _ in range(n)]
        queue: asyncio.Queue = asyncio.Queue()

        async def pump_choice(i, preq, ctx):
            try:
                async for out in entry.generate(preq, ctx):
                    await queue.put((i, out, None))
            except (ServiceUnavailable, RemoteStreamError) as e:
                await queue.put((i, None, e))
            finally:
                await queue.put((i, None, None))  # choice drained

        tasks = [
            asyncio.create_task(pump_choice(i, preq, ctx))
            for i, (preq, ctx) in enumerate(
                zip(self._choice_requests(preprocessed, n), contexts)
            )
        ]
        resp = StreamResponse(
            status=200,
            headers={
                "Content-Type": "text/event-stream",
                "Cache-Control": "no-cache",
            },
        )
        try:
            await resp.prepare(request)
        except BaseException:
            for ctx in contexts:
                ctx.kill()
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            raise
        created = int(time.time())
        eg = StreamEgress(resp, coalesce=self.sse_coalesce,
                          coalesce_max=self.sse_coalesce_max)
        templates: dict = {}  # choice index -> ChunkTemplate
        stamps: list = []     # delta arrival times (observed post-stream)
        ttft_attrs: list = []

        def process(item):
            """One queue item → frames/bookkeeping (no awaits)."""
            nonlocal live, status, ntokens
            i, out, err = item
            if err is not None:
                status = "502"
                eg.add_obj(_sse_error_chunk(rid, str(err)))
                return
            if out is None:
                live -= 1
                return
            if out.get("finish_reason") == "error":
                err = out.get("error", "engine error")
                status = "429" if _shed_error(err) else "500"
                eg.add_obj(_sse_error_chunk(rid, err))
                return
            stamps.append(time.monotonic())
            ids = out.get("token_ids")
            if ids:
                ntokens += len(ids)
            attr = out.get("ttft")
            if attr:  # one-shot, first-token delta only
                ttft_attrs.append(attr)
            finish = out.get("finish_reason")
            if finish is None and not out.get("log_probs"):
                # fast path: splice the text into the pre-serialized
                # skeleton — byte-identical to the json.dumps frame
                text = out.get("text", "")
                # chat deltas with EMPTY text serialize as `delta: {}`,
                # a different shape the skeleton can't splice
                if text or kind != "chat":
                    tmpl = templates.get(i)
                    if tmpl is None:
                        tmpl = templates[i] = ChunkTemplate(_make_chunk(
                            rid, kind, model_name, created,
                            {"text": CONTENT_SENTINEL}, None, index=i,
                        ))
                    eg.add_fast(tmpl, text)
                    return
            eg.add_obj(_make_chunk(rid, kind, model_name, created, out,
                                   finish, index=i, entry=entry))

        live = n
        # keepalive keys off time-since-last-WRITE: one rearming
        # call_later drops a sentinel into the queue when it passes
        loop = asyncio.get_running_loop()
        ka_handle = None

        def rearm_keepalive():
            nonlocal ka_handle
            wait = SSE_KEEPALIVE_S - (time.monotonic() - eg.last_write)
            if wait <= 0:
                queue.put_nowait(_KEEPALIVE)
                wait = SSE_KEEPALIVE_S
            ka_handle = loop.call_later(wait, rearm_keepalive)

        ka_handle = loop.call_later(SSE_KEEPALIVE_S, rearm_keepalive)
        try:
            while live:
                item = await queue.get()
                if item is _KEEPALIVE:
                    if time.monotonic() - eg.last_write >= SSE_KEEPALIVE_S:
                        await eg.ping()
                    continue
                process(item)
                depth = queue.qsize()
                if depth:
                    # the pumps outran the writer: drain the backlog in
                    # one burst → ONE write
                    eg.note_backpressure(depth)
                    for _ in range(min(depth, _MAX_BURST - 1)):
                        it = queue.get_nowait()
                        if it is not _KEEPALIVE:
                            process(it)
                await eg.flush()
            await resp.write(b"data: [DONE]\n\n")
        except (ConnectionResetError, asyncio.CancelledError):
            logger.info("client disconnected; killing %d choice(s)", n)
            for ctx in contexts:
                ctx.kill()
            raise
        finally:
            ka_handle.cancel()
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            # accounting off the delivery path, on the disconnect path too
            if stamps:
                self.metrics.ttft.labels(model_name).observe(stamps[0] - t0)
                observe_itl = self.metrics.itl.labels(model_name).observe
                for a, b in zip(stamps, stamps[1:]):
                    observe_itl(b - a)
            for attr in ttft_attrs:
                self.metrics.observe_ttft_attr(model_name, attr)
            self.metrics.observe_egress(model_name, eg)
        self.metrics.requests.labels(model_name, kind, status).inc()
        self.metrics.output_tokens.labels(model_name).inc(ntokens)
        self.metrics.duration.labels(model_name).observe(time.monotonic() - t0)
        await resp.write_eof()
        return resp

    async def _collect_choice(self, entry, preq, context) -> Dict[str, Any]:
        """Drain one engine stream into an aggregated choice."""
        text_parts = []
        token_ids: list = []
        logprobs: list = []
        tops: list = []
        finish_reason = None
        ttft = None
        async for out in entry.generate(preq, context):
            if out.get("finish_reason") == "error":
                return {"error": out.get("error", "engine error")}
            text_parts.append(out.get("text", ""))
            token_ids.extend(out.get("token_ids", []))
            logprobs.extend(out.get("log_probs", []))
            tops.extend(out.get("top_logprobs", []))
            ttft = out.get("ttft") or ttft
            finish_reason = out.get("finish_reason") or finish_reason
        return {
            "text": "".join(text_parts),
            "token_ids": token_ids,
            "token_count": len(token_ids),
            "log_probs": logprobs,
            "top_logprobs": tops,
            "finish_reason": finish_reason or "stop",
            "ttft": ttft,
        }

    async def _unary_response(
        self, entry, preprocessed, n, rid, kind, model_name, t0
    ) -> Response:
        contexts = [Context() for _ in range(n)]
        tasks = [
            asyncio.create_task(self._collect_choice(entry, preq, ctx))
            for preq, ctx in zip(
                self._choice_requests(preprocessed, n), contexts
            )
        ]
        try:
            results = await asyncio.gather(*tasks)
        except asyncio.CancelledError:
            for ctx in contexts:
                ctx.kill()
            for t in tasks:
                t.cancel()
            raise
        except (ServiceUnavailable, RemoteStreamError) as e:
            # one choice failed: stop its siblings instead of letting them
            # decode unattended to max_tokens
            for ctx in contexts:
                ctx.kill()
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            status = "503" if isinstance(e, ServiceUnavailable) else "502"
            self.metrics.requests.labels(model_name, kind, status).inc()
            return _error_response(int(status), str(e))
        for r in results:
            if r.get("error"):
                shed = _shed_error(r["error"])
                status = "429" if shed else "500"
                self.metrics.requests.labels(model_name, kind, status).inc()
                if shed:
                    return _shed_response(shed)
                return _error_response(500, r["error"])
        prompt_tokens = len(preprocessed.get("token_ids", []))
        for r in results:
            if r.get("ttft"):
                self.metrics.observe_ttft_attr(model_name, r["ttft"])
        token_count = sum(r["token_count"] for r in results)
        usage = {
            "prompt_tokens": prompt_tokens,
            "completion_tokens": token_count,
            "total_tokens": prompt_tokens + token_count,
        }
        want_lp = preprocessed["sampling_options"].get("logprobs")
        choices = []
        for i, r in enumerate(results):
            if kind == "chat":
                choice = {
                    "index": i,
                    "message": {"role": "assistant", "content": r["text"]},
                    "finish_reason": r["finish_reason"],
                }
                if want_lp:
                    choice["logprobs"] = _chat_logprobs(entry, r)
            else:
                choice = {
                    "index": i,
                    "text": r["text"],
                    "finish_reason": r["finish_reason"],
                }
                if want_lp:
                    choice["logprobs"] = _completions_logprobs(entry, r)
            choices.append(choice)
        payload = {
            "id": rid,
            "object": "chat.completion" if kind == "chat" else "text_completion",
            "created": int(time.time()),
            "model": model_name,
            "choices": choices,
            "usage": usage,
        }
        self.metrics.requests.labels(model_name, kind, "200").inc()
        self.metrics.output_tokens.labels(model_name).inc(token_count)
        self.metrics.duration.labels(model_name).observe(time.monotonic() - t0)
        return json_response(payload)


def _token_str(entry, tid: int) -> str:
    try:
        return entry.tokenizer.decode([tid])
    except Exception:  # noqa: BLE001
        return ""


def _chat_logprobs(entry, r) -> Dict[str, Any]:
    """OpenAI chat `logprobs` shape: {"content": [{token, logprob, bytes,
    top_logprobs: [...]}]}."""
    content = []
    tops = r.get("top_logprobs") or []
    for j, tid in enumerate(r["token_ids"]):
        lp = r["log_probs"][j] if j < len(r.get("log_probs", [])) else None
        tok = _token_str(entry, tid)
        item = {
            "token": tok,
            "logprob": lp,
            "bytes": list(tok.encode()),
        }
        if j < len(tops) and tops[j]:
            item["top_logprobs"] = [
                {
                    "token": _token_str(entry, t),
                    "logprob": lv,
                    "bytes": list(_token_str(entry, t).encode()),
                }
                for t, lv in tops[j]
            ]
        content.append(item)
    return {"content": content}


def _completions_logprobs(entry, r) -> Dict[str, Any]:
    """Legacy completions `logprobs` shape: parallel arrays + top-k maps."""
    tokens = [_token_str(entry, t) for t in r["token_ids"]]
    offsets = []
    pos = 0
    for t in tokens:
        offsets.append(pos)
        pos += len(t)
    tops = r.get("top_logprobs") or []
    top_maps = []
    for j in range(len(tokens)):
        if j < len(tops) and tops[j]:
            top_maps.append({_token_str(entry, t): lv for t, lv in tops[j]})
        else:
            top_maps.append(None)
    return {
        "tokens": tokens,
        "token_logprobs": list(r.get("log_probs", [])),
        "top_logprobs": top_maps,
        "text_offset": offsets,
    }


def _make_chunk(rid, kind, model, created, out, finish_reason, index=0,
                entry=None):
    want_lp = entry is not None and out.get("log_probs")
    lp_args = {
        "token_ids": out.get("token_ids", []),
        "log_probs": out.get("log_probs", []),
        "top_logprobs": out.get("top_logprobs", []),
    }
    if kind == "chat":
        delta = {"content": out.get("text", "")} if out.get("text") else {}
        choice = {"index": index, "delta": delta, "finish_reason": finish_reason}
        if want_lp:
            choice["logprobs"] = _chat_logprobs(entry, lp_args)
        return {
            "id": rid,
            "object": "chat.completion.chunk",
            "created": created,
            "model": model,
            "choices": [choice],
        }
    choice = {"index": index, "text": out.get("text", ""),
              "finish_reason": finish_reason}
    if want_lp:
        choice["logprobs"] = _completions_logprobs(entry, lp_args)
    return {
        "id": rid,
        "object": "text_completion",
        "created": created,
        "model": model,
        "choices": [choice],
    }


def _sse_error_chunk(rid, message):
    return {"id": rid, "error": {"message": message, "type": "internal_error"}}


def _error_response(status: int, message: str, code: str = "invalid_request_error"):
    return json_response(
        {"error": {"message": message, "type": code, "code": status}},
        status=status,
    )


def _shed_error(err):
    """The structured overload-shed dict the engine attaches to a shed
    stream ({code: "overloaded", message, retry_after_s}), else None."""
    if isinstance(err, dict) and err.get("code") == "overloaded":
        return err
    return None


def _shed_response(err: dict) -> Response:
    """HTTP 429 for an overload shed, with Retry-After."""
    retry = max(1, int(err.get("retry_after_s") or 1))
    return json_response(
        {"error": {"message": err.get("message", "overloaded"),
                   "type": "overloaded", "code": 429,
                   "retry_after_s": retry}},
        status=429,
        headers={"Retry-After": str(retry)},
    )

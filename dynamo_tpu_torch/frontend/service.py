"""Model discovery + per-model serving pipelines (frontend side).

The port's copy of the JAX package's `frontend/service.py`: round-robin,
random and KV-aware routing (``kv``: a `router.KvRouter` per model picks
the worker, the request goes to it directly).  Every streamed request
goes through request migration (`llm/migration.py`): when its worker dies
mid-stream, the stream is re-issued to another worker with ``prompt +
generated`` as the prompt, within the card's migration limit and backoff,
and counted on the shared `FrontendMetrics`.  The health watcher and SLO
targets are later slices; a card that needs output parsers is skipped
with an error (not ported).  Vision cards (an
``image_token``) are served: their preprocessor expands media.
ModelWatcher watches the control-plane `/models` prefix; each PUT is a
ModelDeploymentCard published by a worker instance under its lease.  The
watcher builds (or refreshes) a ModelEntry: tokenizer + preprocessor + a
routed client to the worker endpoint — the analog of the reference's
`ModelWatcher.handle_put` → `build_routed_pipeline` → `ModelManager`
(lib/llm/src/discovery/watcher.rs:300,
entrypoint/input/common.rs:228, discovery/model_manager.rs:38).
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any, AsyncIterator, Dict, List, Optional

from ..llm import (
    MODEL_ROOT,
    HuggingFaceTokenizer,
    ModelDeploymentCard,
    OpenAIPreprocessor,
    postprocess_stream,
)
from ..llm.migration import migrating_stream
from ..router.worker_key import unpack_worker
from ..runtime import Client, Context, DistributedRuntime
from ..runtime.transport.wire import pack, unpack

logger = logging.getLogger(__name__)


class ModelEntry:
    """One served model: card, tokenizer, preprocessor, routed client."""

    def __init__(self, mdc: ModelDeploymentCard, tokenizer: HuggingFaceTokenizer,
                 client: Client, router_mode: str = "round_robin",
                 metrics=None):
        self.mdc = mdc
        self.tokenizer = tokenizer
        self.preprocessor = OpenAIPreprocessor(mdc, tokenizer)
        self.client = client
        self.router_mode = router_mode
        self.metrics = metrics  # FrontendMetrics (migration counters)
        self.instances: set[int] = set()
        self.kv_chooser = None  # a router.KvRouter in router mode "kv"

    async def route(self, request: Dict[str, Any], context: Context
                    ) -> AsyncIterator[Dict[str, Any]]:
        """Pick a worker per router mode and stream engine outputs.

        Routing is restricted to the instances that published THIS
        model's card: several models can share one component endpoint
        (e.g. a text fleet plus a vision worker on `backend/generate`),
        and the endpoint-level round-robin would happily send a request
        for model A to a worker serving only model B."""
        if self.kv_chooser is not None:
            request = {**request, "request_id": context.id}
            # AllWorkersBusy (an Overloaded ServiceUnavailable) propagates:
            # migration re-raises it and the frontend answers 503
            worker_key = await self.kv_chooser.choose(
                request, allowed=self.instances
            )
            instance_id, dp_rank = unpack_worker(worker_key)
            request["dp_rank"] = dp_rank
            stream = self.client.direct(request, instance_id, context)
            try:
                async for item in stream:
                    yield item
            finally:
                self.kv_chooser.mark_finished(context.id)
            return
        if self.router_mode == "random":
            stream = self.client.random(request, context,
                                        allowed=self.instances)
        else:
            stream = self.client.round_robin(request, context,
                                             allowed=self.instances)
        async for item in stream:
            yield item

    def _on_migration(self, event: str) -> None:
        if self.metrics is not None:
            self.metrics.observe_migration(self.mdc.name, event)

    def generate(self, request: Dict[str, Any], context: Context
                 ) -> AsyncIterator[Dict[str, Any]]:
        """Preprocessed-request in, postprocessed text deltas out (with
        transparent migration on worker loss)."""
        return postprocess_stream(
            migrating_stream(
                request, context, self.route, self.mdc.migration_limit,
                backoff_ms=self.mdc.migration_backoff_ms,
                backoff_max_ms=self.mdc.migration_backoff_max_ms,
                on_migration=self._on_migration,
            ),
            self.tokenizer,
            prompt_ids=request.get("token_ids"),
            stop_sequences=request.get("stop_conditions", {}).get(
                "stop_sequences_text"
            ),
        )


class ModelManager:
    def __init__(self):
        self._entries: Dict[str, ModelEntry] = {}

    def get(self, name: str) -> Optional[ModelEntry]:
        return self._entries.get(name)

    def add(self, name: str, entry: ModelEntry) -> None:
        self._entries[name] = entry

    def remove(self, name: str) -> Optional[ModelEntry]:
        return self._entries.pop(name, None)

    def names(self) -> List[str]:
        return sorted(self._entries)

    def cards(self) -> List[ModelDeploymentCard]:
        return [e.mdc for e in self._entries.values()]


class ModelWatcher:
    """Keeps a ModelManager in sync with the control plane.

    In router mode ``kv``, `kv_chooser_factory` (`router.
    kv_chooser_factory`) builds each new model's KvRouter; the mode
    without a factory, or a factory in another mode, is refused — the
    frontend never falls back from KV routing quietly."""

    def __init__(self, runtime: DistributedRuntime, manager: ModelManager,
                 router_mode: str = "round_robin", kv_chooser_factory=None,
                 metrics=None):
        if router_mode not in ("round_robin", "random", "kv"):
            raise ValueError(f"unknown router mode {router_mode!r} "
                             "(round_robin, random or kv)")
        if (router_mode == "kv") != (kv_chooser_factory is not None):
            raise ValueError("router mode 'kv' takes a kv_chooser_factory, "
                             "and only it does")
        self.runtime = runtime
        self.manager = manager
        self.router_mode = router_mode
        self.kv_chooser_factory = kv_chooser_factory
        self.metrics = metrics  # shared FrontendMetrics, or None
        self._task: Optional[asyncio.Task] = None
        self._ready = asyncio.Event()
        self._choosers: list = []  # every KvRouter built, stopped with us

    async def start(self) -> "ModelWatcher":
        self._task = asyncio.create_task(self._watch())
        return self

    async def stop(self) -> None:
        if self._task:
            self._task.cancel()
            await asyncio.gather(self._task, return_exceptions=True)
        for chooser in self._choosers:
            await chooser.stop()

    async def wait_ready(self, timeout: float = 10.0) -> None:
        await asyncio.wait_for(self._ready.wait(), timeout)

    async def wait_for_model(self, name: str, timeout: float = 30.0) -> ModelEntry:
        deadline = asyncio.get_running_loop().time() + timeout
        while True:
            entry = self.manager.get(name)
            if entry is not None and entry.instances:
                return entry
            if asyncio.get_running_loop().time() > deadline:
                raise TimeoutError(f"model {name} not discovered in {timeout}s")
            await asyncio.sleep(0.05)

    async def _watch(self) -> None:
        from ..runtime.transport.control_plane import watch_resilient

        while True:
            try:
                async for ev in watch_resilient(self.runtime.control,
                                                MODEL_ROOT + "/", "models"):
                    if ev.type == "sync":
                        self._ready.set()
                    elif ev.type == "put":
                        # _handle_put dials the control plane (client
                        # start, kv-chooser snapshot load) — a transient
                        # failure must restart the watch (the fresh
                        # snapshot replays and retries the card), not
                        # kill this task
                        await self._handle_put(ev.key, ev.value)
                    elif ev.type in ("delete", "forget"):
                        # "forget": a card deleted while the watch was
                        # down (e.g. its worker's lease expired during a
                        # control-plane partition) — without it the stale
                        # ModelEntry would keep routing to a dead
                        # instance set forever
                        self._handle_delete(ev.key)
            except (ConnectionError, RuntimeError) as e:
                logger.warning("model watch handler failed (%s); "
                               "re-watching", e)
                await asyncio.sleep(0.2)

    async def _handle_put(self, key: str, value: bytes) -> None:
        try:
            mdc = ModelDeploymentCard.from_dict(unpack(value))
            instance_id = int(key.rsplit("/", 1)[-1])
        except (ValueError, TypeError, KeyError) as e:
            logger.error("bad model card at %s: %s", key, e)
            return
        if mdc.disagg_role in ("prefill", "encode"):
            return  # prefill-only / encode-only workers are not
            # client-facing models (their generate surface speaks the
            # internal disagg protocol, not completions)
        unported = [f for f in ("reasoning_parser", "tool_call_parser")
                    if getattr(mdc, f)]
        if unported:
            logger.error("model %s needs %s: not ported; skipped", mdc.name,
                         ", ".join(unported))
            return
        entry = self.manager.get(mdc.name)
        if entry is None:
            # off the event loop: a pure-Python load of a 128k-token
            # vocabulary takes seconds, longer than a lease may wait
            tokenizer = await asyncio.get_running_loop().run_in_executor(
                None, self._load_tokenizer, mdc)
            if tokenizer is None:
                return
            endpoint = (
                self.runtime.namespace(mdc.namespace)
                .component(mdc.component)
                .endpoint(mdc.endpoint)
            )
            client = await endpoint.client().start()
            entry = ModelEntry(mdc, tokenizer, client, self.router_mode,
                               metrics=self.metrics)
            if self.kv_chooser_factory is not None:
                entry.kv_chooser = await self.kv_chooser_factory(mdc, client)
                self._choosers.append(entry.kv_chooser)
            self.manager.add(mdc.name, entry)
            logger.info("model added: %s (instance %d)", mdc.name, instance_id)
        entry.instances.add(instance_id)

    def _handle_delete(self, key: str) -> None:
        try:
            instance_id = int(key.rsplit("/", 1)[-1])
            slug = key.rsplit("/", 2)[-2]
        except (ValueError, IndexError):
            return
        for name in list(self.manager.names()):
            entry = self.manager.get(name)
            if entry and entry.mdc.slug() == slug:
                entry.instances.discard(instance_id)
                if not entry.instances:
                    self.manager.remove(name)
                    logger.info("model removed: %s", name)

    def _load_tokenizer(self, mdc: ModelDeploymentCard) -> Optional[HuggingFaceTokenizer]:
        try:
            if mdc.tokenizer_json:
                return HuggingFaceTokenizer.from_json_str(
                    mdc.tokenizer_json,
                    eos_token_ids=list(mdc.eos_token_ids),
                    bos_token_id=mdc.bos_token_id,
                    chat_template=mdc.chat_template,
                )
            if mdc.checkpoint_path:
                return HuggingFaceTokenizer.from_pretrained(mdc.checkpoint_path)
        except (OSError, ValueError, NotImplementedError) as e:
            logger.error("tokenizer load failed for %s: %s", mdc.name, e)
        return None


async def register_llm(
    runtime: DistributedRuntime,
    served_endpoint,
    mdc: ModelDeploymentCard,
) -> str:
    """Worker-side: publish the model card under this instance's lease
    (the analog of bindings `register_llm` → `local_model.attach`,
    lib/bindings/python/rust/lib.rs:208)."""
    instance_id = served_endpoint.instance.instance_id
    mdc.namespace = served_endpoint.instance.namespace
    mdc.component = served_endpoint.instance.component
    mdc.endpoint = served_endpoint.instance.endpoint
    key = mdc.card_path(instance_id)
    await runtime.put_leased(key, pack(mdc.to_dict()))
    logger.info("registered model %s at %s", mdc.name, key)
    return key

"""Worker glue: serve a TorchEngine (or any AsyncEngine) as a discovered,
routable model endpoint.

The port's copy of the JAX package's `worker/__init__.py` (`EngineWorker`,
`serve_engine`), with the publishers that feed the KV router: KV events,
load metrics and, for an engine with KVBM tiers, the tier summary.  The
served engine may wrap a `TorchEngine` (the disagg roles' prefill facade
and decode handler hold theirs as ``.engine``).
Data-parallel ranks (`DpRankEngine`) are a later slice.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any, AsyncIterator

from ..engine import ForwardPassMetrics, TorchEngine
from ..frontend.service import register_llm
from ..llm import ModelDeploymentCard, RuntimeConfig
from ..runtime import Context, DistributedRuntime, ServedEndpoint

logger = logging.getLogger(__name__)


class EngineWorker:
    """Wraps an engine with the endpoint handler protocol: request dicts in,
    token-delta dicts out; control requests served inline."""

    def __init__(self, engine: Any):
        self.engine = engine

    async def handle(self, request: Any, context: Context) -> AsyncIterator[Any]:
        if isinstance(request, dict) and "control" in request:
            async for out in self._control(request):
                yield out
            return
        if isinstance(request, dict) and "embed_token_ids" in request:
            yield {"error": "engine does not support embeddings"}
            return
        async for out in self.engine.generate(request, context):
            yield out

    async def _control(self, request: dict) -> AsyncIterator[Any]:
        op = request["control"]
        if op == "clear_kv_blocks":
            cleared = 0
            if hasattr(self.engine, "clear_kv_blocks"):
                # off the loop: the clear waits for the engine's step in
                # flight, and the loop keeps streaming meanwhile
                cleared = await asyncio.get_running_loop().run_in_executor(
                    None, self.engine.clear_kv_blocks)
            yield {"status": "ok", "pages_cleared": cleared}
        elif op == "metrics":
            m = (
                self.engine.metrics()
                if hasattr(self.engine, "metrics")
                else ForwardPassMetrics()
            )
            yield vars(m) if not isinstance(m, dict) else m
        else:
            yield {"status": "error", "error": f"unknown control op {op}"}


async def serve_engine(
    runtime: DistributedRuntime,
    engine: Any,
    mdc: ModelDeploymentCard,
    namespace: str = "dynamo",
    component: str = "backend",
    endpoint: str = "generate",
    publish_kv_events: bool = True,
) -> ServedEndpoint:
    """Register the engine as `{namespace}.{component}.{endpoint}` and
    publish its model card. Returns the served endpoint handle.

    With `publish_kv_events`, an engine with an event sink publishes its
    KV events to the component's durable stream and its load metrics on
    the component's subject, and an engine with KVBM tiers attached its
    lease-scoped tier summary — what a KV router scores."""
    worker = EngineWorker(engine)
    inner = getattr(engine, "engine", engine)
    ep = runtime.namespace(namespace).component(component).endpoint(endpoint)
    served = await ep.serve_endpoint(
        worker.handle,
        health_check_payload={"control": "metrics"},
    )
    wid = served.instance.instance_id
    if publish_kv_events and hasattr(engine, "add_event_sink"):
        from ..router import KvEventPublisher, WorkerMetricsPublisher

        kv_pub = KvEventPublisher(runtime, namespace, component, wid).start()
        engine.add_event_sink(kv_pub.sink)
        served.kv_publisher = kv_pub
        served.metrics_publisher = WorkerMetricsPublisher(
            runtime, engine, namespace, component, wid
        ).start()
    # KVBM fleet-wide prefix reuse: a worker with KV tiers attached also
    # publishes its host/disk tier summary (lease-scoped) so routers can
    # score overlap against blocks that left this worker's device cache
    if publish_kv_events and getattr(inner, "tiered", None) is not None:
        from ..kvbm.summary import TierSummaryPublisher
        from ..router.worker_key import pack_worker

        served.tier_summary_publisher = TierSummaryPublisher(
            runtime, inner.tiered, namespace, component,
            worker_id=pack_worker(wid, 0),
        ).start()
    if isinstance(inner, TorchEngine):
        mdc.kv_cache_block_size = inner.cfg.page_size
        mdc.context_length = inner.cfg.max_model_len
        mdc.runtime_config = RuntimeConfig(
            total_kv_blocks=inner.cfg.usable_pages,
            max_num_seqs=inner.cfg.max_num_seqs,
            max_num_batched_tokens=inner.cfg.max_prefill_tokens,
        )
    await register_llm(runtime, served, mdc)
    return served

"""Worker-side publishers: KV events and load metrics.

The port's copy of the JAX package's `router/publisher.py`.
KvEventPublisher bridges the engine's synchronous event sink into the
control plane's durable stream — the analog of the reference's
engine→NATS-JetStream publisher (lib/llm/src/kv_router/publisher.rs).
WorkerMetricsPublisher periodically publishes ForwardPassMetrics on a
pub/sub subject.  The payloads are the JAX package's, byte for byte, so a
JAX router indexes a port worker and the other way round.
"""

from __future__ import annotations

import asyncio
import logging
from typing import TYPE_CHECKING, Any, Optional

from ..runtime.transport.wire import pack
from .worker_key import pack_worker

if TYPE_CHECKING:
    from ..engine.page_pool import KvEvent
    from ..runtime import DistributedRuntime

logger = logging.getLogger(__name__)


# v2: worker ids in events/metrics are PACKED (instance, dp_rank) keys
# (worker_key.py).  The version in the names keeps routers and workers of
# another key format on disjoint streams/snapshots — mixed formats would
# silently score zero overlap forever.
KV_WIRE_VERSION = "v2"


def kv_stream_name(namespace: str, component: str) -> str:
    return f"kv-events.{KV_WIRE_VERSION}.{namespace}.{component}"


def metrics_subject(namespace: str, component: str) -> str:
    return f"metrics.{KV_WIRE_VERSION}.{namespace}.{component}"


class KvEventPublisher:
    """Engine event sink → durable control-plane stream.  Events key by
    the PACKED (instance, dp_rank) worker id (worker_key.py).

    The sink is called from whichever thread changed the page pool: the
    engine's step thread (commits, evictions), the event loop (park and
    resume, `clear_kv_blocks`) or the KVBM admission path (onboarded
    blocks).  It only packs the event and hands it to the loop, in call
    order, where one task appends the payloads to the stream."""

    def __init__(self, runtime: "DistributedRuntime", namespace: str,
                 component: str, worker_id: int, dp_rank: int = 0):
        self.runtime = runtime
        self.stream = kv_stream_name(namespace, component)
        self.worker_id = pack_worker(worker_id, dp_rank)
        self.dp_rank = dp_rank
        self._queue: asyncio.Queue = asyncio.Queue()
        self._task: Optional[asyncio.Task] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None

    def start(self) -> "KvEventPublisher":
        self._loop = asyncio.get_running_loop()
        self._task = self._loop.create_task(self._drain())
        return self

    def sink(self, ev: "KvEvent") -> None:
        """Thread-safe: callable from the engine's device-step thread."""
        payload = pack(
            {
                "worker_id": self.worker_id,
                "dp_rank": self.dp_rank,
                "kind": ev.kind,
                "block_hashes": ev.block_hashes,
                "parent_hash": ev.parent_hash,
            }
        )
        loop = self._loop
        if loop is None or loop.is_closed():
            return  # not started, or the worker's loop is gone
        loop.call_soon_threadsafe(self._queue.put_nowait, payload)

    async def _drain(self) -> None:
        payload: Optional[bytes] = None
        while True:
            try:
                if payload is None:
                    payload = await self._queue.get()
                await self.runtime.control.stream_append(self.stream, payload)
                payload = None  # only drop after a successful append
            except asyncio.CancelledError:
                return
            except (ConnectionError, RuntimeError) as e:
                logger.warning("kv event publish failed (will retry): %s", e)
                await asyncio.sleep(0.5)

    async def stop(self) -> None:
        if self._task:
            self._task.cancel()
            await asyncio.gather(self._task, return_exceptions=True)


class WorkerMetricsPublisher:
    """Periodic ForwardPassMetrics → pub/sub subject."""

    def __init__(self, runtime: "DistributedRuntime", engine: Any,
                 namespace: str, component: str, worker_id: int,
                 interval: float = 0.5, dp_rank: int = 0):
        self.runtime = runtime
        self.engine = engine
        self.subject = metrics_subject(namespace, component)
        self.worker_id = pack_worker(worker_id, dp_rank)
        self.interval = interval
        self._task: Optional[asyncio.Task] = None

    def start(self) -> "WorkerMetricsPublisher":
        self._task = asyncio.get_running_loop().create_task(self._publish_loop())
        return self

    async def _publish_loop(self) -> None:
        while True:
            try:
                m = self.engine.metrics()
                await self.runtime.control.publish(
                    self.subject,
                    pack({"worker_id": self.worker_id, **vars(m)}),
                )
                await asyncio.sleep(self.interval)
            except asyncio.CancelledError:
                return
            except (ConnectionError, RuntimeError) as e:
                logger.warning("metrics publish failed: %s", e)
                await asyncio.sleep(1.0)

    async def stop(self) -> None:
        if self._task:
            self._task.cancel()
            await asyncio.gather(self._task, return_exceptions=True)

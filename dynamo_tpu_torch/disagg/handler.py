"""Decode-side orchestration and prefill worker serving (the port's copy of
the JAX package's `disagg/handler.py`).

The port has no chaos gates and no tracing spans yet (ROADMAP queue 1,
items 3.4 and 3.6), so the handoff has neither the JAX handler's
`disagg.handoff` chaos gate nor its `disagg.handoff` / `disagg.kv_transfer`
spans; a lost prefill worker, a lost transfer and a rejected import take
the same local fallback and the same counter as there.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any, AsyncIterator, Dict, Optional

from ..llm import ModelDeploymentCard
from ..router.worker_key import unpack_worker
from ..runtime import Client, Context, DistributedRuntime
from ..runtime.transport.service import RemoteStreamError, ServiceUnavailable
from .router import DisaggRouter
from .transfer import LAYOUT_PREFIX, KvTransferClient, KvTransferSource

logger = logging.getLogger(__name__)

PREFILL_COMPONENT = "prefill"


class RemoteRouterClient:
    """Gives the standalone router service (`python -m
    dynamo_tpu_torch.router`) an in-process router's choose/mark_finished
    face.  The service tracks load per request, so all traffic pins to
    one instance; a failed instance triggers a re-pin."""

    def __init__(self, runtime: DistributedRuntime, namespace: str = "dynamo",
                 component: str = "router"):
        ep = runtime.namespace(namespace).component(component).endpoint("generate")
        self.client: Client = ep.client()
        self._router_id: Optional[int] = None
        self._fin_tasks: set = set()

    async def _pin(self) -> int:
        if self._router_id is None:
            await self.client.start()
            await self.client.wait_for_instances(timeout=5.0)
            instances = self.client.instances()
            if not instances:
                raise ServiceUnavailable("no router instances")
            self._router_id = instances[0].instance_id
        return self._router_id

    async def choose(self, request) -> int:
        rid = await self._pin()
        try:
            async for out in self.client.direct(
                {"op": "choose", "token_ids": request.get("token_ids", []),
                 "request_id": request.get("request_id")},
                rid, Context(),
            ):
                if "error" in out:
                    raise ServiceUnavailable(out["error"])
                wid = out.get("worker_id")
                if wid is None:
                    raise ServiceUnavailable(f"malformed router reply: {out}")
                return wid
        except (ServiceUnavailable, RemoteStreamError):
            self._router_id = None  # re-pin next time
            raise
        raise ServiceUnavailable("router returned no decision")

    def mark_finished(self, request_id: str) -> None:
        rid = self._router_id
        if rid is None:
            return

        async def _fin():
            try:
                async for _ in self.client.direct(
                    {"op": "finished", "request_id": request_id}, rid, Context()
                ):
                    break
            except Exception:  # noqa: BLE001 — load tracking is advisory
                pass

        # the loop holds tasks weakly: keep a strong ref until done
        task = asyncio.ensure_future(_fin())
        self._fin_tasks.add(task)
        task.add_done_callback(self._fin_tasks.discard)

    async def stop(self) -> None:
        if self._fin_tasks:
            await asyncio.gather(*list(self._fin_tasks), return_exceptions=True)
        await self.client.stop()


class PrefillFacade:
    """The prefill worker's engine face: every request is a remote-prefill
    request, answered with a transfer descriptor."""

    def __init__(self, engine, source: KvTransferSource):
        self.engine = engine
        self.transfer_source = source

    async def generate(self, request, context):
        yield await self.engine.prefill_remote(
            request, context, transfer_source=self.transfer_source)

    async def shutdown(self):
        if self.transfer_source is not None:
            await self.transfer_source.stop()
        await self.engine.shutdown()

    def metrics(self):
        m = self.engine.metrics()
        src = self.transfer_source
        if src is not None:
            # held transfers and their pages (0 once every client released)
            m.kv_transfer_held = len(src._held)  # noqa: SLF001
            m.kv_transfer_held_pages = src.held_pages
            m.kv_transfer_ipc = int(src.ipc is not None)
        return m

    def clear_kv_blocks(self):
        return self.engine.clear_kv_blocks()

    def add_event_sink(self, sink):
        self.engine.add_event_sink(sink)


async def serve_prefill_worker(
    runtime: DistributedRuntime,
    engine,
    mdc: ModelDeploymentCard,
    namespace: str = "dynamo",
):
    """Serve the engine as a prefill-only worker at {ns}.prefill.generate.
    Publishes its card with disagg_role=prefill (frontends skip it), starts
    the block-ID data plane (KvTransferSource) and registers its KV layout
    once in the control plane.  Returns the served endpoint; its
    `facade` is the engine face it serves, and its `transfer_source`
    stops with it."""
    from ..worker import serve_engine

    # advertise the host the runtime advertises for its endpoints: a
    # loopback default would break cross-host disaggregation
    source = await KvTransferSource(
        engine, host=runtime._advertise_host  # noqa: SLF001
    ).start()
    await source.register_layout(runtime, namespace, PREFILL_COMPONENT)
    mdc.disagg_role = "prefill"
    facade = PrefillFacade(engine, source)
    served = await serve_engine(runtime, facade, mdc, namespace=namespace,
                                component=PREFILL_COMPONENT)
    served.facade = facade
    served.transfer_source = source  # stopped by deregister/runtime.shutdown
    return served


class DisaggDecodeHandler:
    """Wraps a decode engine; remote-prefills long prompts through the
    prefill component and adopts the pages the data plane moves."""

    def __init__(
        self,
        engine,
        runtime: DistributedRuntime,
        namespace: str = "dynamo",
        router: Optional[DisaggRouter] = None,
        prefill_router=None,  # optional router over prefill workers
    ):
        self.engine = engine
        self.runtime = runtime
        self.namespace = namespace
        self.router = router or DisaggRouter()
        self.prefill_router = prefill_router
        ep = (runtime.namespace(namespace).component(PREFILL_COMPONENT)
              .endpoint("generate"))
        self.prefill_client: Client = ep.client()
        self.transfer_client = KvTransferClient(engine)
        self._started = False
        self._layout_watch: Optional[asyncio.Task] = None
        # data-plane observability
        self._inflight_prefills = 0
        self.kv_transfer_count = 0
        self.kv_transfer_ms_total = 0.0
        self.kv_transfer_bytes_total = 0
        self.kv_transfer_device_count = 0  # colocated + ipc fetches
        self.kv_transfer_by_lane: Dict[str, int] = {"device": 0, "ipc": 0,
                                                     "host": 0}
        # handoffs that fell back to a local prefill (remote failure,
        # transfer loss, import rejection)
        self.prefill_fallback_total = 0

    async def _prefill_available(self) -> bool:
        if not self._started:
            await self.prefill_client.start()
            self._started = True
            self._layout_watch = asyncio.ensure_future(self._watch_layouts())
            # give discovery one beat on first use
            try:
                await self.prefill_client.wait_for_instances(timeout=1.0)
            except TimeoutError:
                pass
        return bool(self.prefill_client.instances())

    async def _watch_layouts(self) -> None:
        """Close the ipc lane's mappings of a prefill worker whose lease
        went (its layout key is lease-scoped)."""
        from ..runtime.transport.control_plane import watch_resilient

        prefix = f"{LAYOUT_PREFIX}/{self.namespace}/{PREFILL_COMPONENT}/"
        async for ev in watch_resilient(self.runtime.control, prefix,
                                        "prefill layouts"):
            if ev.type == "DELETE":
                lease = ev.key.rsplit("/", 1)[-1]
                if lease.isdigit():
                    self.transfer_client.ipc.drop(int(lease))

    # AsyncEngine protocol
    async def generate(self, request: Dict[str, Any], context: Context
                       ) -> AsyncIterator[Dict[str, Any]]:
        if isinstance(request, dict) and "control" in request:
            async for out in self._control(request):
                yield out
            return
        prompt = request.get("token_ids") or []
        # media prompts prefill here: the adopted KV would come without the
        # sequence's embeddings' M-RoPE delta
        has_media = any(request.get(k) is not None
                        for k in ("mm_pixels", "mm_patches", "mm_embeds"))
        remote = not has_media and self.router.should_prefill_remotely(
            len(prompt),
            cached_prefix_len=self.engine.cached_prefix_len(prompt),
            prefill_workers_available=await self._prefill_available(),
            prefill_queue_depth=self._inflight_prefills,
        )
        if not remote:
            async for out in self.engine.generate(request, context):
                yield out
            return
        # -- remote prefill ------------------------------------------------- #
        prefill_ctx = context.child()
        self._inflight_prefills += 1
        try:
            if self.prefill_router is not None:
                key = await self.prefill_router.choose(
                    {**request, "request_id": prefill_ctx.id})
                inst, dp_rank = unpack_worker(key)
                stream = self.prefill_client.direct(
                    {**request, "dp_rank": dp_rank}, inst, prefill_ctx)
            else:
                stream = self.prefill_client.round_robin(request, prefill_ctx)
            result = None
            async for item in stream:
                result = item
                break
        except (ServiceUnavailable, RemoteStreamError, OSError) as e:
            # OSError: raw socket failures dialing a dead prefill worker
            # whose instance key has not expired yet
            logger.warning("remote prefill failed (%s); prefilling locally", e)
            self.prefill_fallback_total += 1
            async for out in self.engine.generate(request, context):
                yield out
            return
        finally:
            self._inflight_prefills -= 1
            if self.prefill_router is not None:
                self.prefill_router.mark_finished(prefill_ctx.id)
        if not result or "error" in result or (
            "kv" not in result and "kv_descriptor" not in result
        ):
            logger.warning("remote prefill rejected (%s); local fallback",
                           (result or {}).get("error"))
            self.prefill_fallback_total += 1
            async for out in self.engine.generate(request, context):
                yield out
            return
        first_token = result["token_ids"][0]
        if "kv_descriptor" in result:
            # block-ID data plane: fetch pages, then adopt them
            try:
                pages, stats = await self.transfer_client.fetch(
                    result["kv_descriptor"], timeout=30.0)
            except Exception as e:  # noqa: BLE001 — any failure → local
                logger.warning("kv transfer failed (%s); prefilling locally", e)
                self.prefill_fallback_total += 1
                async for out in self.engine.generate(request, context):
                    yield out
                return
            self.kv_transfer_count += 1
            self.kv_transfer_ms_total += stats.ms
            self.kv_transfer_bytes_total += stats.bytes
            self.kv_transfer_by_lane[stats.lane] = (
                self.kv_transfer_by_lane.get(stats.lane, 0) + 1)
            if stats.lane in ("device", "ipc"):
                self.kv_transfer_device_count += 1
            logger.debug(
                "kv transfer %d pages -> %d pages, %.1fKB in %.1fms (%s)",
                stats.src_pages, stats.dest_pages, stats.bytes / 1024, stats.ms,
                stats.lane)
            async for out in self.engine.generate_imported(
                request, first_token, pages, context
            ):
                yield out
            return
        import_failed = False
        async for out in self.engine.generate_with_kv(
            request, first_token, result["kv"], context
        ):
            if out.get("finish_reason") == "error" and "kv import rejected" in (
                out.get("error") or ""
            ):
                import_failed = True
                break
            yield out
        if import_failed:
            logger.warning("kv import rejected; prefilling locally")
            self.prefill_fallback_total += 1
            async for out in self.engine.generate(request, context):
                yield out

    async def _control(self, request: dict) -> AsyncIterator[Any]:
        op = request["control"]
        if op == "clear_kv_blocks":
            cleared = await asyncio.get_running_loop().run_in_executor(
                None, self.engine.clear_kv_blocks)
            yield {"status": "ok", "pages_cleared": cleared}
        elif op == "metrics":
            yield vars(self.metrics())
        else:
            yield {"status": "error", "error": f"unknown control op {op}"}

    def metrics(self):
        m = self.engine.metrics()
        m.kv_transfer_count = self.kv_transfer_count
        m.kv_transfer_ms_total = round(self.kv_transfer_ms_total, 3)
        m.kv_transfer_bytes_total = self.kv_transfer_bytes_total
        m.kv_transfer_device_count = self.kv_transfer_device_count
        for lane, n in self.kv_transfer_by_lane.items():
            setattr(m, f"kv_transfer_{lane}_count", n)
        m.kv_transfer_ipc_mapped = self.transfer_client.ipc.mapped
        m.prefill_fallback_total = self.prefill_fallback_total
        return m

    def clear_kv_blocks(self):
        return self.engine.clear_kv_blocks()

    def add_event_sink(self, sink):
        self.engine.add_event_sink(sink)

    async def shutdown(self):
        if self._layout_watch is not None:
            self._layout_watch.cancel()
            await asyncio.gather(self._layout_watch, return_exceptions=True)
        await self.prefill_client.stop()
        if self.prefill_router is not None and hasattr(self.prefill_router, "stop"):
            await self.prefill_router.stop()
        await self.engine.shutdown()

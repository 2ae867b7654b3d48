"""Endpoint Client: instance discovery + routed request dispatch.

The port's copy of the JAX package's `runtime/client.py`.  Reference: lib/runtime/src/component/client.rs:40 (`Client`,
`InstanceSource::{Static,Dynamic}`) and pipeline/network/egress/push_router.rs:41
(`PushRouter`, RouterMode Random/RoundRobin/Direct/KV).  One discovery watcher
per endpoint is shared across client handles.  Routing modes here are
client-side picks over the live instance list followed by a direct TCP stream
to the chosen worker.
"""

from __future__ import annotations

import asyncio
import logging
import random
from typing import Any, AsyncIterator

from .component import Endpoint, Instance
from .engine import Context
from .transport.service import Overloaded, ServiceUnavailable

logger = logging.getLogger(__name__)


class Client:
    """Client for one endpoint; resolves live instances via a discovery watch."""

    def __init__(self, endpoint: Endpoint, static_instances: list[Instance] | None = None):
        self.endpoint = endpoint
        self.runtime = endpoint.runtime
        self._static = static_instances
        self._instances: dict[int, Instance] = {
            i.instance_id: i for i in (static_instances or [])
        }
        self._watch_task: asyncio.Task | None = None
        self._synced = asyncio.Event()
        self._rr = 0
        # Instances that just refused a connection, kept out of the pick
        # until the deadline.  A crashed worker lingers in `_instances`
        # for up to the lease TTL; migration retries are much faster than
        # that and would otherwise burn the whole retry budget on the
        # corpse.  Routing hint only: never turns into a 503 on its own.
        self._cooldown: dict[int, float] = {}
        self.cooldown_s = 3.0
        if static_instances is not None:
            self._synced.set()

    # -- discovery ---------------------------------------------------------- #

    async def start(self) -> "Client":
        if self._static is None and self._watch_task is None:
            self._watch_task = asyncio.create_task(self._watch())
        return self

    async def _watch(self) -> None:
        from .transport.control_plane import watch_resilient

        async for ev in watch_resilient(
            self.runtime.control, self.endpoint.path_prefix,
            f"discovery:{self.endpoint.wire_name}",
        ):
            if ev.type == "sync":
                self._synced.set()
            elif ev.type == "put":
                inst = Instance.from_bytes(ev.value)
                self._instances[inst.instance_id] = inst
            elif ev.type in ("delete", "forget"):
                # "forget" replays a deregistration that happened while
                # the watch was down (watch_resilient's reconcile), so
                # vanished instances are dropped here too
                iid = int(ev.key.rsplit("/", 1)[-1])
                self._instances.pop(iid, None)

    async def wait_for_instances(self, timeout: float = 10.0) -> list[Instance]:
        """Block until at least one instance is live."""
        await self.start()
        deadline = asyncio.get_running_loop().time() + timeout
        await asyncio.wait_for(self._synced.wait(), timeout)
        while not self._instances:
            if asyncio.get_running_loop().time() > deadline:
                raise TimeoutError(
                    f"no instances for {self.endpoint.wire_name} within {timeout}s"
                )
            await asyncio.sleep(0.05)
        return self.instances()

    def instances(self) -> list[Instance]:
        return sorted(self._instances.values(), key=lambda i: i.instance_id)

    def instance_ids(self) -> list[int]:
        return sorted(self._instances)

    async def stop(self) -> None:
        if self._watch_task:
            self._watch_task.cancel()
            await asyncio.gather(self._watch_task, return_exceptions=True)

    # -- routing ------------------------------------------------------------ #

    def _candidates(self, allowed) -> list[Instance]:
        """Live instances, optionally restricted to an id set (several
        models can share one endpoint; a model's requests must only
        reach instances that serve it).  An allowed set with no live
        member is a 503, NOT a fallback to every instance — other
        instances on the endpoint may serve a different model, and
        routing there would return wrong-model completions."""
        insts = self.instances()
        if allowed:
            insts = [i for i in insts if i.instance_id in allowed]
            if not insts:
                raise ServiceUnavailable(
                    f"no live instance among the {len(allowed)} allowed for "
                    f"{self.endpoint.wire_name}"
                )
        if not insts:
            raise ServiceUnavailable(f"no instances for {self.endpoint.wire_name}")
        if self._cooldown:
            now = asyncio.get_running_loop().time()
            warm = [
                i for i in insts
                if self._cooldown.get(i.instance_id, 0.0) <= now
            ]
            # All candidates cooling down means we have nowhere better to
            # send the request — fall through to the full list rather than
            # fabricating a 503 out of a routing hint.
            if warm:
                insts = warm
        return insts

    def _pick_random(self, allowed=None) -> Instance:
        return random.choice(self._candidates(allowed))

    def _pick_round_robin(self, allowed=None) -> Instance:
        insts = self._candidates(allowed)
        inst = insts[self._rr % len(insts)]
        self._rr += 1
        return inst

    def _pick_direct(self, instance_id: int) -> Instance:
        inst = self._instances.get(instance_id)
        if inst is None:
            raise ServiceUnavailable(
                f"instance {instance_id} not live for {self.endpoint.wire_name}"
            )
        return inst

    async def _routed(
        self, pick, request: Any, context: Context | None
    ) -> AsyncIterator[Any]:
        # Lazily start discovery so `ep.client().generate(...)` works without
        # an explicit start()/wait_for_instances() dance.
        if self._static is None and self._watch_task is None:
            await self.start()
        if not self._instances and self._static is None:
            try:
                await self.wait_for_instances(timeout=5.0)
            except TimeoutError as e:
                raise ServiceUnavailable(str(e)) from e
        inst = pick()
        svc = self.runtime.service_client
        try:
            async for item in svc.call_stream(
                inst.address, inst.service_endpoint, request, context
            ):
                yield item
        except ServiceUnavailable as e:
            # Couldn't reach (or lost) this instance: cool it down so
            # retries pick someone else while discovery catches up and
            # expires the lease.  Overloaded is deliberate shedding from a
            # healthy worker — no cooldown.
            if not isinstance(e, Overloaded):
                self._cooldown[inst.instance_id] = (
                    asyncio.get_running_loop().time() + self.cooldown_s
                )
            raise

    def random(self, request: Any, context: Context | None = None,
               allowed=None) -> AsyncIterator[Any]:
        return self._routed(
            lambda: self._pick_random(allowed), request, context
        )

    def round_robin(self, request: Any, context: Context | None = None,
                    allowed=None) -> AsyncIterator[Any]:
        return self._routed(
            lambda: self._pick_round_robin(allowed), request, context
        )

    def direct(self, request: Any, instance_id: int,
               context: Context | None = None) -> AsyncIterator[Any]:
        """Route to one named instance (the KV router's pick)."""
        return self._routed(lambda: self._pick_direct(instance_id), request,
                            context)

    async def generate(self, request: Any,
                       context: Context | None = None) -> AsyncIterator[Any]:
        """Default routing (round-robin) — AsyncEngine-compatible."""
        async for item in self.round_robin(request, context):
            yield item

"""Component hierarchy: Namespace → Component → Endpoint → Instance.

The port's copy of the JAX package's `runtime/component.py`.  Mirrors the reference's naming/registration model
(lib/runtime/src/component.rs:549,150,384,97 and
docs/architecture/distributed_runtime.md:56-60): an endpoint instance is
registered in the discovery KV under
``/services/{namespace}/{component}/{endpoint}/{instance_id}`` scoped to the
worker's primary lease, so a crashed worker disappears when the lease
expires.  The value carries the instance's direct TCP address — clients dial
workers straight (see transport/service.py for why there is no broker hop).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any

from .transport.service import Handler
from .transport.wire import pack, unpack

logger = logging.getLogger(__name__)

INSTANCE_ROOT = "/services"


@dataclass(frozen=True)
class Instance:
    namespace: str
    component: str
    endpoint: str
    instance_id: int
    address: str  # host:port of the worker's ServiceServer
    transport: str = "tcp"

    @property
    def path(self) -> str:
        return (
            f"{INSTANCE_ROOT}/{self.namespace}/{self.component}/"
            f"{self.endpoint}/{self.instance_id}"
        )

    @property
    def service_endpoint(self) -> str:
        """Endpoint name on the wire (unique per component+endpoint)."""
        return f"{self.namespace}.{self.component}.{self.endpoint}"

    def to_bytes(self) -> bytes:
        return pack(
            {
                "namespace": self.namespace,
                "component": self.component,
                "endpoint": self.endpoint,
                "instance_id": self.instance_id,
                "address": self.address,
                "transport": self.transport,
            }
        )

    @staticmethod
    def from_bytes(data: bytes) -> "Instance":
        d = unpack(data)
        return Instance(**d)


class Namespace:
    def __init__(self, runtime: "DistributedRuntime", name: str):  # noqa: F821
        self.runtime = runtime
        self.name = name

    def component(self, name: str) -> "Component":
        return Component(self, name)

    def __repr__(self):
        return f"Namespace({self.name})"


class Component:
    def __init__(self, namespace: Namespace, name: str):
        self.namespace = namespace
        self.name = name
        self.runtime = namespace.runtime

    def endpoint(self, name: str) -> "Endpoint":
        return Endpoint(self, name)

    @property
    def path(self) -> str:
        return f"{INSTANCE_ROOT}/{self.namespace.name}/{self.name}"

    def __repr__(self):
        return f"Component({self.namespace.name}.{self.name})"


class Endpoint:
    def __init__(self, component: Component, name: str):
        self.component = component
        self.name = name
        self.runtime = component.runtime

    @property
    def path_prefix(self) -> str:
        return f"{self.component.path}/{self.name}/"

    @property
    def wire_name(self) -> str:
        return f"{self.component.namespace.name}.{self.component.name}.{self.name}"

    async def serve_endpoint(
        self,
        handler: Handler,
        *,
        graceful_shutdown: bool = True,
        health_check_payload: Any | None = None,
        metrics_labels: dict[str, str] | None = None,
    ) -> "ServedEndpoint":
        """Register `handler` on this process's ServiceServer and publish the
        instance under the runtime's primary lease."""
        rt = self.runtime
        server = await rt.ensure_service_server()
        server.register(self.wire_name, handler)
        instance = Instance(
            namespace=self.component.namespace.name,
            component=self.component.name,
            endpoint=self.name,
            instance_id=rt.primary_lease,
            address=rt.advertise_address(),
        )
        await rt.put_leased(instance.path, instance.to_bytes())
        served = ServedEndpoint(self, instance, graceful_shutdown, health_check_payload)
        rt._served.append(served)
        logger.info("serving endpoint %s at %s", instance.path, instance.address)
        return served

    def client(self) -> "Client":
        from .client import Client

        return Client(self)

    def __repr__(self):
        return f"Endpoint({self.wire_name})"


class ServedEndpoint:
    def __init__(self, endpoint: Endpoint, instance: Instance,
                 graceful_shutdown: bool, health_check_payload: Any | None):
        self.endpoint = endpoint
        self.instance = instance
        self.graceful_shutdown = graceful_shutdown
        self.health_check_payload = health_check_payload
        # services a worker attaches, stopped on deregister: KV event and
        # metrics publishers (one per engine rank), the KVBM tier summary,
        # the disagg transfer source
        self.kv_publisher: list = []
        self.metrics_publisher: list = []
        self.tier_summary_publisher = None
        self.transfer_source = None

    async def deregister(self) -> None:
        """Remove from discovery (stop receiving new requests)."""
        for svc in (*self.kv_publisher, *self.metrics_publisher,
                    self.tier_summary_publisher, self.transfer_source):
            if svc is not None:
                await svc.stop()
        await self.endpoint.runtime.delete_leased(self.instance.path)
        self.endpoint.runtime.service_server.unregister(self.endpoint.wire_name)

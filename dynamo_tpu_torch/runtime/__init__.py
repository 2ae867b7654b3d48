"""dynamo_tpu_torch.runtime — the port's copy of the distributed runtime
kernel: control plane (discovery/leases/pub-sub), component hierarchy,
direct TCP streaming transport, request cancellation."""

from .client import Client
from .component import Component, Endpoint, Instance, Namespace, ServedEndpoint
from .engine import Context
from .runtime import DistributedRuntime
from .transport.control_plane import (
    ControlPlaneClient,
    ControlPlaneServer,
    WatchEvent,
)
from .transport.service import (
    Overloaded,
    RemoteStreamError,
    ServiceClient,
    ServiceServer,
    ServiceUnavailable,
)

__all__ = [
    "Client",
    "Component",
    "Context",
    "ControlPlaneClient",
    "ControlPlaneServer",
    "DistributedRuntime",
    "Endpoint",
    "Instance",
    "Namespace",
    "Overloaded",
    "RemoteStreamError",
    "ServedEndpoint",
    "ServiceClient",
    "ServiceServer",
    "ServiceUnavailable",
    "WatchEvent",
]

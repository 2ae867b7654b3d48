"""The port's serving engine: paged KV pool, continuous-batching
scheduler (copied host modules) and the flat single-device TorchEngine."""

from .config import EngineConfig, bucket_for
from .engine import ForwardPassMetrics, TorchEngine
from .page_pool import KvEvent, NoPagesError, PagePool
from .scheduler import SamplingOptions, Scheduler, Sequence

__all__ = [
    "EngineConfig",
    "ForwardPassMetrics",
    "KvEvent",
    "NoPagesError",
    "PagePool",
    "SamplingOptions",
    "Scheduler",
    "Sequence",
    "TorchEngine",
    "bucket_for",
]

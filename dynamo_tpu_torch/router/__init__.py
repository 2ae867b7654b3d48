"""KV-cache-aware routing: indexers, cost-based scheduler, publishers (the
port's copy of the JAX package's `router/`)."""

from .indexer import ApproxKvIndexer, PyRadixIndex, RadixIndex
from .kv_router import AllWorkersBusy, KvRouter, kv_chooser_factory
from .publisher import (
    KvEventPublisher,
    WorkerMetricsPublisher,
    kv_stream_name,
    metrics_subject,
)
from .scheduler import (
    KvWorkerSelector,
    SchedulingDecision,
    WorkerSelector,
    WorkerState,
)
from .sequence import ActiveSequences

__all__ = [
    "AllWorkersBusy",
    "ActiveSequences",
    "ApproxKvIndexer",
    "KvEventPublisher",
    "KvRouter",
    "KvWorkerSelector",
    "PyRadixIndex",
    "RadixIndex",
    "SchedulingDecision",
    "WorkerMetricsPublisher",
    "WorkerSelector",
    "WorkerState",
    "kv_chooser_factory",
    "kv_stream_name",
    "metrics_subject",
]

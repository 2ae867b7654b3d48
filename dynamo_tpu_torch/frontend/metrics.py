"""Frontend Prometheus metrics, with the JAX package's metric names
(`dynamo_frontend_*`, its `frontend/metrics.py`), written as Prometheus
text by a small exposition of the port's own (the GPU machine has no
`prometheus_client`).

Kept: request, in-flight, TTFT, ITL, TTFT attribution, duration and
output-token families, the egress counters (frames, writes, coalesced
deltas, backpressure, CPU seconds, bytes, queue depth) and the migration
counters (`observe_migration`).  The speculative-decoding, shed,
endpoint-health, SLO-window and process collectors belong to features the
port has not taken yet.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

_TTFT_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0
)
_ITL_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0)
# prometheus_client's default histogram buckets
_DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.075, 0.1, 0.25, 0.5, 0.75,
                    1.0, 2.5, 5.0, 7.5, 10.0)


def _num(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    return repr(float(v))


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')


class _Metric:
    """A labelled metric family; `labels(...)` returns the child for one
    label tuple, created on first use."""

    kind = ""

    def __init__(self, name: str, doc: str, labelnames: Sequence[str] = (),
                 registry: Optional["Registry"] = None):
        self.name, self.doc = name, doc
        self.labelnames = tuple(labelnames)
        self._children: Dict[Tuple[str, ...], object] = {}
        self._lock = threading.Lock()
        if registry is not None:
            registry.register(self)

    def labels(self, *values):
        key = tuple(str(v) for v in values)
        if len(key) != len(self.labelnames):
            raise ValueError(f"{self.name} takes labels {self.labelnames}")
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._child()
        return child

    def _lbl(self, key, extra: str = "") -> str:
        parts = [f'{n}="{_escape(v)}"' for n, v in zip(self.labelnames, key)]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    def render(self) -> List[str]:
        lines = [f"# HELP {self.name} {self.doc}", f"# TYPE {self.name} {self.kind}"]
        for key, child in sorted(self._children.items()):
            lines.extend(self._samples(key, child))
        return lines


class _Value:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.value -= amount


class Counter(_Metric):
    kind = "counter"

    def _child(self):
        return _Value()

    def _samples(self, key, child):
        name = self.name if self.name.endswith("_total") else self.name + "_total"
        return [f"{name}{self._lbl(key)} {_num(child.value)}"]


class Gauge(_Metric):
    kind = "gauge"

    def _child(self):
        return _Value()

    def _samples(self, key, child):
        return [f"{self.name}{self._lbl(key)} {_num(child.value)}"]


class _Hist:
    __slots__ = ("bounds", "counts", "sum")

    def __init__(self, bounds):
        self.bounds = bounds
        self.counts = [0] * len(bounds)
        self.sum = 0.0

    def observe(self, value: float) -> None:
        self.sum += value
        for i, b in enumerate(self.bounds):
            if value <= b:
                self.counts[i] += 1
                break


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, doc, labelnames=(), buckets=_DEFAULT_BUCKETS,
                 registry=None):
        super().__init__(name, doc, labelnames, registry)
        self.bounds = tuple(float(b) for b in buckets) + (math.inf,)

    def _child(self):
        return _Hist(self.bounds)

    def _samples(self, key, child):
        out, cum = [], 0
        for b, c in zip(child.bounds, child.counts):
            cum += c
            out.append(f"{self.name}_bucket{self._lbl(key, f'le=\"{_num(b)}\"')} "
                       f"{_num(cum)}")
        out.append(f"{self.name}_count{self._lbl(key)} {_num(cum)}")
        out.append(f"{self.name}_sum{self._lbl(key)} {_num(child.sum)}")
        return out


class Registry:
    def __init__(self):
        self._metrics: List[_Metric] = []

    def register(self, metric: _Metric) -> None:
        self._metrics.append(metric)

    def exposition(self) -> bytes:
        lines = [ln for m in self._metrics for ln in m.render()]
        return ("\n".join(lines) + "\n").encode()


def engine_stats_exposition(stats: dict, namespace: str = "",
                            component: str = "") -> bytes:
    """The worker's ``dynamo_tpu_worker_*`` families from a live
    engine-stats dict (``vars(engine.metrics())``), as the JAX package's
    `EngineStatsCollector` builds them on every scrape: ``*_total`` stats
    are counters -- a dict-valued one (``decode_cc_fallout_total``) one
    counter family labelled by ``reason`` -- and the other numbers
    gauges."""
    reg = Registry()
    labels = ("dynamo_namespace", "dynamo_component")
    for key, value in stats.items():
        name = f"dynamo_tpu_worker_{key}"
        if isinstance(value, dict) and key.endswith("_total"):
            fam = Counter(name[:-len("_total")], f"engine {key} (live), by reason",
                          labels + ("reason",), registry=reg)
            for reason, n in sorted(value.items()):
                fam.labels(namespace, component, reason).inc(n)
            continue
        if not isinstance(value, (int, float)) or isinstance(value, bool):
            continue
        if key.endswith("_total"):
            fam = Counter(name[:-len("_total")], f"engine {key} (live)", labels,
                          registry=reg)
        else:
            fam = Gauge(name, f"engine {key} (live)", labels, registry=reg)
        fam.labels(namespace, component).inc(value)
    return reg.exposition()


class FrontendMetrics:
    def __init__(self, registry: Optional[Registry] = None):
        self.registry = r = registry or Registry()
        self.requests = Counter(
            "dynamo_frontend_requests_total", "Completed HTTP requests",
            ["model", "kind", "status"], registry=r)
        self.inflight = Gauge(
            "dynamo_frontend_inflight_requests", "Requests currently being served",
            ["model"], registry=r)
        self.ttft = Histogram(
            "dynamo_frontend_time_to_first_token_seconds", "Time to first token",
            ["model"], buckets=_TTFT_BUCKETS, registry=r)
        self.itl = Histogram(
            "dynamo_frontend_inter_token_latency_seconds", "Inter-token latency",
            ["model"], buckets=_ITL_BUCKETS, registry=r)
        # TTFT attribution: the engine splits each request's TTFT into
        # block-wait, queue-wait and prefill and ships the split on the
        # first delivered delta
        self.ttft_block_wait = Histogram(
            "dynamo_frontend_ttft_block_wait_seconds",
            "TTFT share spent behind the in-flight decode block",
            ["model"], buckets=_TTFT_BUCKETS, registry=r)
        self.ttft_queue_wait = Histogram(
            "dynamo_frontend_ttft_queue_wait_seconds",
            "TTFT share spent waiting for scheduler admission",
            ["model"], buckets=_TTFT_BUCKETS, registry=r)
        self.ttft_prefill = Histogram(
            "dynamo_frontend_ttft_prefill_seconds",
            "TTFT share spent prefilling the prompt",
            ["model"], buckets=_TTFT_BUCKETS, registry=r)
        self.duration = Histogram(
            "dynamo_frontend_request_duration_seconds", "Whole-request duration",
            ["model"], registry=r)
        self.output_tokens = Counter(
            "dynamo_frontend_output_tokens_total", "Generated tokens",
            ["model"], registry=r)
        # egress data plane (frontend/egress.py): per-stream counters
        # flushed in ONE post-stream batch by observe_egress
        self.egress_frames = Counter(
            "dynamo_frontend_egress_frames_total",
            "SSE frames written (coalescing merges deltas into fewer)",
            ["model"], registry=r)
        self.egress_writes = Counter(
            "dynamo_frontend_egress_writes_total",
            "resp.write calls (a burst drain sends many frames per write)",
            ["model"], registry=r)
        self.egress_coalesced = Counter(
            "dynamo_frontend_egress_coalesced_deltas_total",
            "Token deltas merged into a preceding frame under backpressure",
            ["model"], registry=r)
        self.egress_backpressure = Counter(
            "dynamo_frontend_egress_backpressure_events_total",
            "Queue drains that began with deltas already backed up",
            ["model"], registry=r)
        self.egress_cpu = Counter(
            "dynamo_frontend_egress_cpu_seconds_total",
            "Frontend CPU spent building + writing SSE frames "
            "(divide by output tokens for per-token cost)",
            ["model"], registry=r)
        self.egress_bytes = Counter(
            "dynamo_frontend_egress_bytes_total",
            "SSE bytes written (frames + keepalive pings)",
            ["model"], registry=r)
        self.egress_queue_depth = Histogram(
            "dynamo_frontend_egress_queue_depth",
            "Write-queue backlog observed at each backpressure drain",
            ["model"], buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512), registry=r)
        # fault tolerance: migration counters incremented straight from
        # migrating_stream (frontend/service.py wires the callback)
        self.migrations = Counter(
            "dynamo_frontend_migrations_total",
            "Streams transparently re-issued to another worker",
            ["model"], registry=r)
        self.migration_exhausted = Counter(
            "dynamo_frontend_migration_exhausted_total",
            "Streams that hit the migration limit (client saw an error)",
            ["model"], registry=r)

    def observe_egress(self, model: str, eg) -> None:
        """Flush one stream's egress counters (a StreamEgress) — called
        once per stream from the post-stream accounting block."""
        self.egress_frames.labels(model).inc(eg.frames)
        if eg.writes:
            self.egress_writes.labels(model).inc(eg.writes)
        if eg.coalesced:
            self.egress_coalesced.labels(model).inc(eg.coalesced)
        if eg.backpressure_events:
            self.egress_backpressure.labels(model).inc(eg.backpressure_events)
        self.egress_cpu.labels(model).inc(eg.cpu_ns / 1e9)
        self.egress_bytes.labels(model).inc(eg.bytes_out)
        if eg.depth_samples:
            observe = self.egress_queue_depth.labels(model).observe
            for depth in eg.depth_samples:
                observe(depth)

    def observe_migration(self, model: str, event: str) -> None:
        """Account one migrating_stream event ('migrated'/'exhausted')."""
        if event == "exhausted":
            self.migration_exhausted.labels(model).inc()
        else:
            self.migrations.labels(model).inc()

    def observe_ttft_attr(self, model: str, ttft: dict) -> None:
        """Account one request's engine-side TTFT attribution ({
        block_wait_ms, queue_wait_ms, prefill_ms})."""
        for hist, key in (
            (self.ttft_block_wait, "block_wait_ms"),
            (self.ttft_queue_wait, "queue_wait_ms"),
            (self.ttft_prefill, "prefill_ms"),
        ):
            v = ttft.get(key)
            if isinstance(v, (int, float)) and v >= 0:
                hist.labels(model).observe(v / 1e3)

    def exposition(self) -> bytes:
        """Prometheus text format 0.0.4."""
        return self.registry.exposition()

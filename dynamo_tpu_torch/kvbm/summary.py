"""Per-worker KV-tier prefix summaries — the fleet-wide half of KVBM (the
port's copy of the JAX package's `kvbm/summary.py`).

Each worker with tiers attached periodically publishes the block hashes
resident in its host-DRAM (G2) and disk (G3) tiers, lease-scoped under::

    /kvbm/summary/{namespace}/{component}/{packed_worker_id}

(riding the ``/telemetry/`` publisher pattern: compact payloads with
``ts``/``seq``/``interval_s``, written with ``put_leased`` so a dead
worker's summary disappears WITH its lease).  ``KvRouter`` watches the
prefix into a per-worker tier RadixIndex and folds the resulting *tier
overlap* into its cost-based selection — so the overlap score consults
global cache state (a prefix sitting in another worker's DRAM or disk
tier) rather than only device residency from KV events.

Two deliberate asymmetries vs the telemetry plane:

- replace, don't accumulate: a summary put REPLACES the worker's prior
  tier view in the router's index (tier residency is a set, not an event
  stream — LRU evictions must disappear);
- drop, don't retain-stale: on lease loss (delete/forget) the worker's
  summary leaves the index immediately.  Stale capacity data is worth
  surfacing; stale cache data routes requests at a cache that
  evaporated, which is strictly worse than routing cold.
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
from typing import Optional

from ..runtime.transport.wire import pack

logger = logging.getLogger(__name__)

SUMMARY_ROOT = "/kvbm/summary"


def _env_number(name: str, default, cast, lenient: bool):
    """A number from the environment.  A malformed value raises, unless
    `lenient` (a cadence knob whose typo must not stop the worker): then
    it is logged and the default kept."""
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return cast(raw)
    except ValueError:
        if not lenient:
            raise ValueError(f"{name} must be a number, got {raw!r}") from None
        logger.warning("ignoring %s=%r (not a number); using %s",
                       name, raw, default)
        return default


def summary_prefix(namespace: str, component: str) -> str:
    return f"{SUMMARY_ROOT}/{namespace}/{component}/"


def summary_key(namespace: str, component: str, worker_id: int) -> str:
    return f"{summary_prefix(namespace, component)}{worker_id}"


class TierSummaryPublisher:
    """Periodic tier-summary snapshots → lease-scoped KV key.

    Publishes only when the tier contents actually changed (a busy-idle
    worker's unchanged multi-thousand-hash summary is not rewritten every
    tick); the lease scope handles removal."""

    def __init__(self, runtime, tiered, namespace: str = "dynamo",
                 component: str = "backend", worker_id: int = 0,
                 interval_s: Optional[float] = None,
                 max_hashes: Optional[int] = None):
        self.runtime = runtime
        self.tiered = tiered
        self.namespace = namespace
        self.component = component
        self.worker_id = worker_id
        self.interval_s = (
            interval_s if interval_s is not None
            else _env_number("DYN_TPU_KVBM_SUMMARY_INTERVAL", 1.0, float,
                             lenient=True)
        )
        self.max_hashes = (
            max_hashes if max_hashes is not None
            else _env_number("DYN_TPU_KVBM_SUMMARY_MAX", 8192, int,
                             lenient=False)
        )
        self._task: Optional[asyncio.Task] = None
        self._seq = 0
        self._last_digest: Optional[int] = None

    @property
    def key(self) -> str:
        return summary_key(self.namespace, self.component, self.worker_id)

    def start(self) -> "TierSummaryPublisher":
        self._task = asyncio.get_running_loop().create_task(self._loop())
        return self

    async def stop(self) -> None:
        if self._task:
            self._task.cancel()
            await asyncio.gather(self._task, return_exceptions=True)

    async def _loop(self) -> None:
        while True:
            try:
                await self.publish_once()
            except asyncio.CancelledError:
                return
            except Exception as e:  # noqa: BLE001 — keep publishing
                logger.warning("kvbm summary publish failed for %s: %s",
                               self.key, e)
            await asyncio.sleep(self.interval_s)

    async def publish_once(self) -> Optional[dict]:
        """Build + publish one summary; returns the payload, or None when
        the tier contents are unchanged since the last publish (also the
        test hook)."""
        # off-loop: DiskTier.summary() takes the tier lock, which the
        # drain thread holds across np.savez demotion writes — summarize
        # on an executor so demotion churn never stalls the worker's
        # token-streaming loop
        s = await asyncio.get_running_loop().run_in_executor(
            None, self.tiered.summary, self.max_hashes
        )
        # content digest, not order digest: the router's view is a set, so
        # pure recency churn (a lookup hit reordering MRU) must not
        # republish a multi-thousand-hash payload every tick — only a
        # change in WHICH hashes are resident (including cap-truncation
        # picking a different subset) does
        digest = hash((frozenset(s["host"]), frozenset(s["disk"])))
        if digest == self._last_digest:
            return None
        self._seq += 1
        payload = {
            "ts": time.time(),
            "seq": self._seq,
            "interval_s": self.interval_s,
            "worker_id": self.worker_id,
            "host": s["host"],
            "disk": s["disk"],
        }
        await self.runtime.put_leased(self.key, pack(payload))
        self._last_digest = digest
        return payload

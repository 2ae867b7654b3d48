"""KvRouter — KV-cache-aware worker selection for one model endpoint.

The port's copy of the JAX package's `router/kv_router.py`: the
frontend-side composition of the router's pieces (reference
lib/llm/src/kv_router/kv_router.rs `KvRouter` and subscriber.rs
`start_kv_router_background`):

- consumes the component's durable KV-event stream into a RadixIndex,
  resuming from a radix snapshot in the object store when present (and
  writing one each `snapshot_threshold` events);
- consumes worker ForwardPassMetrics from pub/sub;
- watches the KVBM tier summaries into a second index (tier overlap);
- tracks its own routing decisions in ActiveSequences (and, when engines
  emit no events, in the ApproxKvIndexer);
- `choose(request)` runs the cost-based selector over live instances.

Multiple router replicas converge because they read the same event stream
and snapshots; the stream, the subject and the snapshot's bucket and name
are the JAX package's, so either package's router reads either package's
workers.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Dict, Optional, Sequence

from ..runtime import Client, DistributedRuntime
from ..runtime.transport.service import Overloaded, ServiceUnavailable
from ..runtime.transport.wire import pack, unpack
from ..tokens import compute_block_hash_for_seq
from .indexer import ApproxKvIndexer, RadixIndex
from .publisher import KV_WIRE_VERSION, kv_stream_name, metrics_subject
from .scheduler import KvWorkerSelector, SchedulingDecision, WorkerState
from .sequence import ActiveSequences
from .worker_key import pack_worker, unpack_worker

logger = logging.getLogger(__name__)

SNAPSHOT_BUCKET = "kv-router-snapshots"


class AllWorkersBusy(Overloaded):
    """Every live worker is above the busy threshold — callers shed load
    (the frontend answers 503; reference worker_monitor.rs
    `KvWorkerMonitor` busy gating)."""


class KvRouter:
    def __init__(
        self,
        runtime: DistributedRuntime,
        namespace: str,
        component: str,
        client: Client,
        block_size: int = 16,
        overlap_score_weight: float = 1.0,
        temperature: float = 0.0,
        use_approx: bool = False,
        snapshot_threshold: int = 1000,
        salt: str = "",
        busy_threshold: float = 0.0,  # kv_usage above this = busy; 0 = off
    ):
        self.runtime = runtime
        self.client = client
        self.namespace = namespace
        self.component = component
        self.block_size = block_size
        self.salt = salt
        self.stream = kv_stream_name(namespace, component)
        self.metrics_subject = metrics_subject(namespace, component)
        self.snapshot_name = f"{namespace}.{component}@{KV_WIRE_VERSION}"
        self.busy_threshold = busy_threshold
        self.snapshot_threshold = snapshot_threshold
        self.index = RadixIndex()
        # KVBM global prefix index: worker → blocks resident in its
        # host/disk tiers, fed by the lease-scoped summary watch (a put
        # REPLACES the worker's view; lease loss DROPS it — stale tier
        # data would route requests at an evaporated cache)
        self.tier_index = RadixIndex()
        self.approx = ApproxKvIndexer() if use_approx else None
        self.active = ActiveSequences()
        self.selector = KvWorkerSelector(overlap_score_weight, temperature)
        self.worker_states: Dict[int, WorkerState] = {}
        self._tasks: list[asyncio.Task] = []
        self._events_seen = 0
        self._last_snapshot_at = 0
        self._event_offset = 0
        # the latest SchedulingDecision (what the debug line logs)
        self.last_decision: Optional[SchedulingDecision] = None

    # -- lifecycle ----------------------------------------------------------- #

    async def start(self) -> "KvRouter":
        await self._load_snapshot()
        loop = asyncio.get_running_loop()
        self._tasks = [
            loop.create_task(self._event_loop()),
            loop.create_task(self._metrics_loop()),
            loop.create_task(self._summary_loop()),
        ]
        return self

    async def stop(self) -> None:
        for t in self._tasks:
            t.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)

    # -- background sync ----------------------------------------------------- #

    async def _load_snapshot(self) -> None:
        try:
            data = await self.runtime.control.obj_get(
                SNAPSHOT_BUCKET, self.snapshot_name
            )
        except (ConnectionError, RuntimeError):
            return
        if not data:
            return
        try:
            snap = unpack(data)
            self.index = RadixIndex.from_snapshot(
                {int(w): hs for w, hs in snap["workers"].items()}
            )
            self._event_offset = snap.get("offset", 0)
        except (ValueError, KeyError, TypeError) as e:
            logger.error("corrupt kv-router snapshot ignored: %s", e)
            return
        logger.info(
            "kv router resumed from snapshot at offset %d", self._event_offset
        )

    async def _maybe_snapshot(self) -> None:
        if self._events_seen - self._last_snapshot_at < self.snapshot_threshold:
            return
        self._last_snapshot_at = self._events_seen
        snap = pack({
            # msgpack map keys must be strings (strict_map_key on unpack)
            "workers": {str(w): hs for w, hs in self.index.snapshot().items()},
            "offset": self._event_offset,
        })
        try:
            await self.runtime.control.obj_put(
                SNAPSHOT_BUCKET, self.snapshot_name, snap
            )
        except (ConnectionError, RuntimeError) as e:
            logger.warning("snapshot write failed: %s", e)

    async def _event_loop(self) -> None:
        while True:
            try:
                entries, _last, first_avail = await self.runtime.control.stream_fetch(
                    self.stream, after=self._event_offset, timeout_ms=1000
                )
                if self._event_offset and self._event_offset < first_avail - 1:
                    # gap: events between our offset and first_avail aged
                    # out of retention — resync from snapshot (reference
                    # kv_cache_routing.md)
                    await self._resync_after_gap(first_avail)
                    continue
                for entry in entries:
                    self._event_offset = entry["seq"]
                    self._apply_event(unpack(entry["data"]))
                    self._events_seen += 1
                await self._maybe_snapshot()
            except asyncio.CancelledError:
                return
            except (ConnectionError, RuntimeError) as e:
                logger.warning("kv event fetch failed: %s", e)
                await asyncio.sleep(0.5)

    async def _resync_after_gap(self, first_avail: int) -> None:
        """Events were lost past retention: reload the latest snapshot; if
        it is still older than the gap, drop the stale index (engines keep
        their caches — the router conservatively under-estimates overlap
        until fresh events rebuild it)."""
        old_offset = self._event_offset
        await self._load_snapshot()
        if self._event_offset < first_avail - 1:
            self.index = RadixIndex()
            self._event_offset = first_avail - 1
        logger.warning(
            "kv event gap (offset %d < first available %d); resynced to %d",
            old_offset, first_avail, self._event_offset,
        )

    def _apply_event(self, ev: dict) -> None:
        wid = ev["worker_id"]
        kind = ev["kind"]
        if kind == "stored":
            self.index.apply_stored(wid, ev["block_hashes"])
        elif kind == "removed":
            self.index.apply_removed(wid, ev["block_hashes"])
        elif kind == "cleared":
            self.index.clear_worker(wid)

    async def _summary_loop(self) -> None:
        """Watch the KVBM tier summaries for this component into
        `tier_index` (kvbm/summary.py).  Puts replace the worker's tier
        view; deletes and forgets — a summary key vanishing with its
        lease — drop the worker from the index immediately, so the
        overlap score can never send a request chasing cache state whose
        owner is gone."""
        from ..kvbm.summary import summary_prefix
        from ..runtime.transport.control_plane import watch_resilient

        prefix = summary_prefix(self.namespace, self.component)
        while True:
            try:
                async for ev in watch_resilient(self.runtime.control, prefix,
                                                "kvbm-summary"):
                    if ev.type == "put":
                        try:
                            payload = unpack(ev.value)
                            wid = int(ev.key[len(prefix):])
                        except (ValueError, TypeError, KeyError):
                            continue
                        if not isinstance(payload, dict):
                            continue
                        try:
                            self._apply_summary(wid, payload)
                        except (TypeError, ValueError):
                            # malformed field (version skew/corruption)
                            # must drop the EVENT, not kill the watch —
                            # a dead loop retains every worker's tier
                            # view stale forever
                            logger.warning(
                                "malformed kvbm summary from worker %d "
                                "dropped", wid)
                    elif ev.type in ("delete", "forget"):
                        try:
                            wid = int(ev.key[len(prefix):])
                        except ValueError:
                            continue
                        self.tier_index.remove_worker(wid)
            except asyncio.CancelledError:
                return
            except (ConnectionError, RuntimeError) as e:
                logger.warning("kvbm summary watch failed: %s", e)
                await asyncio.sleep(0.5)

    def _apply_summary(self, wid: int, payload: dict) -> None:
        hashes = list(payload.get("host") or []) + list(
            payload.get("disk") or []
        )
        self.tier_index.remove_worker(wid)
        if hashes:
            self.tier_index.apply_stored(wid, hashes)

    async def _metrics_loop(self) -> None:
        while True:
            try:
                sub = await self.runtime.control.subscribe(self.metrics_subject)
                async for _subject, msg in sub:
                    m = unpack(msg)
                    wid = m.pop("worker_id")
                    self.worker_states[wid] = WorkerState(
                        worker_id=wid,
                        active_seqs=m.get("active_seqs", 0),
                        waiting_seqs=m.get("waiting_seqs", 0),
                        kv_usage=m.get("kv_usage", 0.0),
                        kv_usage_aggregate=m.get("kv_usage_aggregate"),
                        kv_total_pages=m.get("kv_total_pages", 0),
                    )
            except asyncio.CancelledError:
                return
            except (ConnectionError, RuntimeError) as e:
                logger.warning("metrics subscribe failed: %s", e)
                await asyncio.sleep(0.5)

    # -- the routing decision ------------------------------------------------ #

    def _live_workers(self) -> Dict[int, WorkerState]:
        """Live candidates keyed by PACKED (instance, dp_rank) worker id.

        Discovery yields instances; published metrics reveal each
        instance's dp ranks (a multi-rank worker publishes one
        ForwardPassMetrics per rank).  An instance with no metrics yet is
        routable at rank 0 so brand-new workers take traffic."""
        live_inst = {inst.instance_id for inst in self.client.instances()}
        live: Dict[int, WorkerState] = {
            key: st for key, st in self.worker_states.items()
            if unpack_worker(key)[0] in live_inst
        }
        covered = {unpack_worker(key)[0] for key in live}
        for iid in live_inst - covered:
            k0 = pack_worker(iid, 0)
            live[k0] = WorkerState(worker_id=k0)
        # drop state/index entries for dead workers (all their ranks)
        for key in list(self.worker_states):
            if unpack_worker(key)[0] not in live_inst:
                del self.worker_states[key]
                self.index.remove_worker(key)
                self.tier_index.remove_worker(key)
                self.active.remove_worker(key)
                if self.approx:
                    self.approx.remove_worker(key)
        return live

    async def choose(self, request: dict, allowed=None) -> int:
        """Pick a worker for a preprocessed request; updates load tracking.

        Returns a PACKED (instance, dp_rank) worker key — callers unpack
        with `worker_key.unpack_worker`, route with
        `client.direct(request, instance)`, and put the rank in
        `request["dp_rank"]`.  `allowed` restricts candidate INSTANCES
        (e.g. to the instances serving one model when several models
        share a component endpoint)."""
        token_ids: Sequence[int] = request.get("token_ids", [])
        # cache_salt (e.g. per-image content hash on multimodal requests)
        # must match the engine's block-hash chain or indexed blocks from
        # KV events could never score overlap for these requests
        hashes = compute_block_hash_for_seq(
            token_ids, self.block_size,
            self.salt + str(request.get("cache_salt") or ""),
        )
        await self.client.wait_for_instances(timeout=5.0)
        workers = self._live_workers()
        if allowed:
            workers = {
                wid: st for wid, st in workers.items()
                if unpack_worker(wid)[0] in allowed
            }
            if not workers:
                # NOT a fallback to every worker: unscoped workers on a
                # shared endpoint may serve a different model — routing
                # there would return wrong-model completions
                raise ServiceUnavailable(
                    f"no live worker among the {len(allowed)} instances "
                    "serving this model"
                )
        if self.busy_threshold > 0:
            free = {
                wid: st for wid, st in workers.items()
                if st.kv_usage <= self.busy_threshold
            }
            if not free:
                raise AllWorkersBusy(
                    f"all {len(workers)} workers above kv_usage "
                    f"{self.busy_threshold:.2f}"
                )
            workers = free
        overlaps = self.index.find_matches(hashes)
        if self.approx:
            a = self.approx.find_matches(hashes)
            for w, o in a.items():
                overlaps[w] = max(overlaps.get(w, 0), o)
        # KVBM tier overlap: leading runs resident in workers' host/disk
        # tiers (fed by the lease-scoped summary watch) — the global,
        # not-just-device half of the overlap score
        tier_overlaps = self.tier_index.find_matches(hashes)
        request_blocks = max(len(hashes), 1)
        decision = self.selector.select(
            workers, overlaps, request_blocks, self.active,
            tier_overlaps=tier_overlaps,
        )
        self.last_decision = decision
        rid = request.get("request_id") or request.get("id") or str(id(request))
        self.active.add_request(
            rid,
            decision.worker_id,
            # tier-resolvable blocks onboard instead of prefilling — the
            # pending-prefill load estimate should not count them
            prefill_blocks=max(
                0, request_blocks - decision.overlap_blocks
                - decision.tier_overlap_blocks,
            ),
            decode_blocks=request_blocks,
        )
        if self.approx:
            self.approx.process_routing_decision(decision.worker_id, hashes)
        # the decision's attributes (the JAX package's `router.schedule`
        # span; the port's tracing is not there yet)
        logger.debug(
            "kv route %s -> worker %d (dp_rank %d, overlap %d/%d, tier "
            "overlap %d, %d candidates)",
            rid, decision.worker_id, unpack_worker(decision.worker_id)[1],
            decision.overlap_blocks, request_blocks,
            decision.tier_overlap_blocks, len(workers),
        )
        return decision.worker_id

    def mark_finished(self, request_id: str) -> None:
        self.active.free(request_id)


def kv_chooser_factory(runtime: DistributedRuntime, **kw):
    """Factory handed to ModelWatcher: builds one KvRouter per model."""

    async def factory(mdc, client) -> KvRouter:
        router = KvRouter(
            runtime,
            mdc.namespace,
            mdc.component,
            client,
            block_size=mdc.kv_cache_block_size,
            **kw,
        )
        return await router.start()

    return factory

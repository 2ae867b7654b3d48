"""KvScheduler — worker selection.

The port's copy of the JAX package's `router/scheduler.py`.  Cost formula
(reference docs/architecture/kv_cache_routing.md and
kv_router/scheduler.rs):

    potential_prefill_blocks = request_blocks - overlap_blocks[worker]
    potential_decode_blocks  = worker's active decode blocks + request_blocks
    cost = overlap_score_weight * potential_prefill_blocks
           + potential_decode_blocks

Lowest cost wins; with router_temperature > 0 the choice is sampled from
softmax(-cost/temperature) for load spreading.  A pluggable WorkerSelector
mirrors the reference's custom-selector trait.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass, field
from typing import Dict, Optional, Protocol

from .sequence import ActiveSequences


@dataclass
class WorkerState:
    """Latest published load for one worker (from ForwardPassMetrics)."""

    worker_id: int
    active_seqs: int = 0
    waiting_seqs: int = 0
    # kv_usage is the worker's ADMISSION-binding usage (max over pool
    # partitions — one full partition blocks admission); busy-shed keys
    # off it.  kv_usage_aggregate is the pool-wide fraction (equal to
    # kv_usage on unpartitioned workers) — load estimates that multiply
    # by kv_total_pages must use the aggregate, or an imbalanced pooled
    # worker with three near-empty partitions looks fully busy
    kv_usage: float = 0.0
    kv_usage_aggregate: Optional[float] = None
    kv_total_pages: int = 0

    @property
    def usage_aggregate(self) -> float:
        return (self.kv_usage if self.kv_usage_aggregate is None
                else self.kv_usage_aggregate)


@dataclass
class SchedulingDecision:
    worker_id: int
    overlap_blocks: int
    costs: Dict[int, float] = field(default_factory=dict)
    # leading blocks resolvable from the chosen worker's HOST/DISK tiers
    # beyond its device overlap (KVBM onboarding instead of prefill)
    tier_overlap_blocks: int = 0


class WorkerSelector(Protocol):
    def select(
        self,
        workers: Dict[int, WorkerState],
        overlaps: Dict[int, int],
        request_blocks: int,
        active: ActiveSequences,
        tier_overlaps: Optional[Dict[int, int]] = None,
    ) -> SchedulingDecision: ...


class KvWorkerSelector:
    """The default cost-based selector.

    With KVBM tier summaries (`tier_overlaps`), a worker whose host/disk
    tier holds a leading run of the request's blocks avoids prefilling
    them too — it onboards at `onboard_cost_weight` of a prefilled
    block's cost (device→host copies are cheap next to recompute but not
    free), so the effective prefill estimate becomes::

        effective_overlap = max(device_overlap, tier_overlap)
        prefill_cost = (request_blocks - effective_overlap)
                     + onboard_cost_weight * max(0, tier - device)
    """

    def __init__(self, overlap_score_weight: float = 1.0,
                 temperature: float = 0.0, rng: Optional[random.Random] = None,
                 onboard_cost_weight: float = 0.25):
        self.overlap_score_weight = overlap_score_weight
        self.temperature = temperature
        self.onboard_cost_weight = onboard_cost_weight
        self._rng = rng or random.Random(0x5EED)

    def select(self, workers, overlaps, request_blocks, active,
               tier_overlaps=None):
        tier_overlaps = tier_overlaps or {}
        costs: Dict[int, float] = {}
        eff: Dict[int, float] = {}
        for wid, st in workers.items():
            overlap = overlaps.get(wid, 0)
            tier = tier_overlaps.get(wid, 0)
            effective = max(overlap, tier)
            onboard = max(0, tier - overlap)
            eff[wid] = effective
            pending_prefill, resident_decode = active.load(wid)
            prefill = ((request_blocks - effective)
                       + self.onboard_cost_weight * onboard
                       + pending_prefill)
            decode = resident_decode + request_blocks
            # worker-published load joins the estimate: pool-wide usage
            # scales the decode pressure (full workers get costlier)
            decode += st.usage_aggregate * st.kv_total_pages
            costs[wid] = self.overlap_score_weight * prefill + decode
        if not costs:
            raise RuntimeError("no workers to select from")
        if self.temperature <= 0:
            # deterministic: min cost, ties → highest effective overlap
            # (device beats tier at equal depth via cost) then lowest id
            wid = min(
                costs,
                key=lambda w: (costs[w], -eff.get(w, 0), w),
            )
        else:
            wids = list(costs)
            logits = [-costs[w] / self.temperature for w in wids]
            mx = max(logits)
            probs = [math.exp(l - mx) for l in logits]
            total = sum(probs)
            r = self._rng.random() * total
            acc = 0.0
            wid = wids[-1]
            for w, p in zip(wids, probs):
                acc += p
                if r <= acc:
                    wid = w
                    break
        return SchedulingDecision(
            wid, overlaps.get(wid, 0), costs,
            tier_overlap_blocks=max(
                0, tier_overlaps.get(wid, 0) - overlaps.get(wid, 0)
            ),
        )

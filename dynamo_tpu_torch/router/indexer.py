"""KV-cache indexers: who has which blocks.

The port's copy of the JAX package's `router/indexer.py`.  The
exact-knowledge path is the index fed by engine KV events (reference
lib/llm/src/kv_router/indexer.rs `RadixTree`, `find_matches`,
`apply_event`); the fallback when engines emit no events is the
ApproxKvIndexer predicting cache contents from routing decisions with TTL
decay (approx.rs).

Chained block hashes (`dynamo_tpu_torch.tokens`) mean "worker has hash
h_i" implies it stored block i of that exact prefix — overlap is the
longest leading run of hashes the worker holds.

`RadixIndex` is the pure-Python `PyRadixIndex`: the JAX package selects
the same class whenever its C++ index (`native/radix_index.cpp`) is not
built, and the port has no build of that library of its own yet.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple


class PyRadixIndex:
    """block hash → workers holding it, with per-worker reverse sets."""

    def __init__(self):
        self._by_hash: Dict[int, Set[int]] = defaultdict(set)
        self._by_worker: Dict[int, Set[int]] = defaultdict(set)

    # -- events -------------------------------------------------------------- #

    def apply_stored(self, worker_id: int, block_hashes: Iterable[int]) -> None:
        for h in block_hashes:
            self._by_hash[h].add(worker_id)
            self._by_worker[worker_id].add(h)

    def apply_removed(self, worker_id: int, block_hashes: Iterable[int]) -> None:
        for h in block_hashes:
            workers = self._by_hash.get(h)
            if workers:
                workers.discard(worker_id)
                if not workers:
                    del self._by_hash[h]
            self._by_worker[worker_id].discard(h)

    def remove_worker(self, worker_id: int) -> None:
        for h in self._by_worker.pop(worker_id, set()):
            workers = self._by_hash.get(h)
            if workers:
                workers.discard(worker_id)
                if not workers:
                    del self._by_hash[h]

    def clear_worker(self, worker_id: int) -> None:
        self.remove_worker(worker_id)

    # -- queries ------------------------------------------------------------- #

    def find_matches(self, block_hashes: Sequence[int]) -> Dict[int, int]:
        """worker_id → overlap (longest leading run of blocks it holds)."""
        overlap: Dict[int, int] = {}
        active: Optional[Set[int]] = None
        for i, h in enumerate(block_hashes):
            holders = self._by_hash.get(h)
            if not holders:
                break
            active = holders if active is None else (active & holders)
            if not active:
                break
            for w in active:
                overlap[w] = i + 1
        return overlap

    def workers(self) -> List[int]:
        return sorted(self._by_worker)

    def num_blocks(self, worker_id: int) -> int:
        return len(self._by_worker.get(worker_id, ()))

    # -- snapshot ------------------------------------------------------------ #

    def snapshot(self) -> Dict[int, List[int]]:
        return {w: sorted(hs) for w, hs in self._by_worker.items()}

    @staticmethod
    def from_snapshot(data: Dict[int, List[int]]) -> "PyRadixIndex":
        idx = PyRadixIndex()
        for w, hs in data.items():
            idx.apply_stored(int(w), hs)
        return idx


RadixIndex = PyRadixIndex


class ApproxKvIndexer:
    """Predict cache contents from routing decisions (no engine events).

    Every routed request inserts its block hashes for the chosen worker
    with a TTL; queries expire stale entries lazily (reference approx.rs —
    TTL default 120s)."""

    def __init__(self, ttl_secs: float = 120.0, clock=time.monotonic):
        self.ttl = ttl_secs
        self._clock = clock
        self._index = RadixIndex()
        self._expiry: Dict[Tuple[int, int], float] = {}  # (worker, hash) → t

    def process_routing_decision(self, worker_id: int,
                                 block_hashes: Sequence[int]) -> None:
        now = self._clock()
        self._index.apply_stored(worker_id, block_hashes)
        for h in block_hashes:
            self._expiry[(worker_id, h)] = now + self.ttl

    def _expire(self) -> None:
        now = self._clock()
        dead = [(w, h) for (w, h), t in self._expiry.items() if t < now]
        per_worker: Dict[int, List[int]] = defaultdict(list)
        for w, h in dead:
            del self._expiry[(w, h)]
            per_worker[w].append(h)
        for w, hs in per_worker.items():
            self._index.apply_removed(w, hs)

    def find_matches(self, block_hashes: Sequence[int]) -> Dict[int, int]:
        self._expire()
        return self._index.find_matches(block_hashes)

    def remove_worker(self, worker_id: int) -> None:
        self._index.remove_worker(worker_id)
        self._expiry = {
            k: v for k, v in self._expiry.items() if k[0] != worker_id
        }

"""Device KV page allocator with prefix caching and KV events.

This is the engine-resident sibling of the reference's KVBM device pool
(reference lib/llm/src/block_manager/pool.rs `ManagedBlockPool`:
active/inactive registries, reuse, reset) fused with vLLM-style prefix
caching, because our engine owns its own pages:

- pages move free → active (owned by a sequence) → cached (full, hashed,
  shareable, refcounted) → evicted (LRU) → free
- full pages are *committed* under their chained block hash; later
  sequences with the same prefix reuse them without recompute
- commits/evictions emit KV events (stored/removed) consumed by the
  KV-aware router (reference events.rs → publisher.rs)

Page 0 is reserved (trash page for padding writes) and never allocated.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence


@dataclass
class KvEvent:
    """stored/removed event, the unit the router's indexer consumes
    (reference kv_router/protocols.rs KvCacheEvent)."""

    kind: str  # "stored" | "removed" | "cleared"
    block_hashes: List[int]
    parent_hash: Optional[int] = None
    ts: float = field(default_factory=time.monotonic)


class NoPagesError(RuntimeError):
    pass


class PagePool:
    """Free-list page allocator + hash-addressed prefix cache."""

    ranks = 1  # partition count (the scheduler's rank-aware surface)

    def __init__(self, num_pages: int, page_size: int,
                 event_sink: Optional[Callable[[KvEvent], None]] = None):
        self.page_size = page_size
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages - 1, 0, -1))  # pop() → 1,2,...
        # block_hash → page id (full committed pages)
        self._cached: Dict[int, int] = {}
        self._page_hash: Dict[int, int] = {}  # page id → block hash
        self._refs: Dict[int, int] = {}  # page id → refcount (active users)
        # unreferenced cached pages in LRU order (evictable)
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        self._event_sink = event_sink
        # optional StepEventRecorder (runtime.events): alloc/free land on
        # the engine step timeline; None-checked so the hot path stays a
        # single attribute load when unwired
        self.events = None

    # -- stats --------------------------------------------------------------- #

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def evictable_pages(self) -> int:
        return len(self._lru)

    @property
    def available_pages(self) -> int:
        return self.free_pages + self.evictable_pages

    def usage(self) -> float:
        """Fraction of the pool that is NOT reclaimable (pages held by
        running sequences).  Cached-but-evictable pages count as free —
        they are capacity, not load; counting them as used would make
        the router/busy-threshold systematically penalize cache-rich
        workers (vLLM v1 semantics: cached blocks sit in the free
        queue)."""
        usable = self.num_pages - 1
        return 1.0 - (self.available_pages / usable) if usable else 1.0

    def usage_max_rank(self) -> float:
        """Usage of the FULLEST partition — the admission-binding signal
        (a single pool has one partition, so this equals `usage`)."""
        return self.usage()

    # -- allocation ---------------------------------------------------------- #

    def allocate(self, n: int) -> List[int]:
        """Take n pages, evicting cached pages LRU-first if needed."""
        if self.available_pages < n:
            raise NoPagesError(f"need {n} pages, have {self.available_pages}")
        out: List[int] = []
        while len(out) < n:
            if self._free:
                out.append(self._free.pop())
            else:
                out.append(self._evict_one())
        for p in out:
            self._refs[p] = self._refs.get(p, 0) + 1
        if self.events is not None:
            self.events.record("pool_alloc", n=n,
                               available=self.available_pages)
        return out

    def _evict_one(self) -> int:
        page, _ = self._lru.popitem(last=False)
        h = self._page_hash.pop(page)
        del self._cached[h]
        self._emit(KvEvent("removed", [h]))
        return page

    def free(self, pages: Sequence[int]) -> None:
        """Release a sequence's hold. Cached pages become evictable; others
        return to the free list."""
        if self.events is not None and pages:
            self.events.record("pool_free", n=len(pages))
        for p in pages:
            refs = self._refs.get(p, 0) - 1
            if refs > 0:
                self._refs[p] = refs
                continue
            self._refs.pop(p, None)
            if p in self._page_hash:
                self._lru[p] = None  # still cached, now evictable
            else:
                self._free.append(p)

    # -- prefix cache -------------------------------------------------------- #

    def lookup(self, block_hashes: Sequence[int]) -> List[int]:
        """Longest cached prefix: page ids for the leading run of hits.
        Takes a reference on each returned page."""
        out: List[int] = []
        for h in block_hashes:
            page = self._cached.get(h)
            if page is None:
                break
            if page in self._lru:
                del self._lru[page]
            self._refs[page] = self._refs.get(page, 0) + 1
            out.append(page)
        return out

    def cached_page(self, block_hash: int) -> Optional[int]:
        """Page currently committed under this hash, or None — no reference
        taken (KVBM offload resolves hashes to live pages through this)."""
        return self._cached.get(block_hash)

    def peek(self, block_hashes: Sequence[int]) -> int:
        """Length of the leading cached run WITHOUT taking references
        (disagg-router costing: `cached_prefix_len`)."""
        n = 0
        for h in block_hashes:
            if h not in self._cached:
                break
            n += 1
        return n

    def commit(self, page: int, block_hash: int, parent_hash: Optional[int]) -> int:
        """Register a now-full page under its chain hash.

        If an identical block is already cached (another sequence filled the
        same prefix concurrently), the existing page wins: the caller keeps
        using its own copy (it holds a ref) but the cache dedups to one.
        Returns the canonical page id for the hash.
        """
        existing = self._cached.get(block_hash)
        if existing is not None:
            return existing
        self._cached[block_hash] = page
        self._page_hash[page] = block_hash
        self._emit(KvEvent("stored", [block_hash], parent_hash))
        return page

    def clear_cache(self) -> int:
        """Drop every evictable cached page (the reference's
        `clear_kv_blocks` endpoint). Returns pages reclaimed."""
        n = 0
        while self._lru:
            self._free.append(self._evict_one())
            n += 1
        self._emit(KvEvent("cleared", []))
        return n

    # rank-aware surface (trivial on the single pool; the copied Scheduler
    # always goes through these)

    def available_on(self, rank: int) -> int:
        return self.available_pages

    def allocate_on(self, rank: int, n: int) -> List[int]:
        return self.allocate(n)

    def lookup_on(self, rank: int, block_hashes: Sequence[int]) -> List[int]:
        return self.lookup(block_hashes)

    def best_rank(self, block_hashes: Sequence[int]):
        """(rank, cached-prefix-hits) of the best partition to admit a
        sequence with this hash chain."""
        return 0, self.peek(block_hashes)

    def _emit(self, ev: KvEvent) -> None:
        if self._event_sink:
            self._event_sink(ev)

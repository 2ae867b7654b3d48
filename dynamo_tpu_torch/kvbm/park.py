"""Preemption parking lot — host-side KV storage for parked decodes (the
port's copy of the JAX package's `kvbm/park.py`).

Overload control preempts batch-class sequences *mid-decode*: unlike the
classic recompute preemption (free the pages, re-prefill the prompt), a
mid-decode victim's output-token KV cannot be recomputed bit-exactly —
prefill runs ``[B, T, D]`` matmuls where decode ran ``[B, 1, D]``, and
the last-ulp differences would break the token-identity contract on
resume.  So preemption *parks*: the victim's live pages (including the
partial tail page) are copied device→host byte-exact and held here,
keyed by request id, until admission resumes the sequence by importing
the same bytes into fresh pages.  Together with the sequence's preserved
``num_computed`` / ``output_tokens`` / per-request seed (PRNG counters
derive from ``len(output_tokens)``), the round trip is token-identical —
greedy and seeded.

The lot is bounded by ``park_max_pages`` (0 = unbounded): at budget the
scheduler simply stops preempting (victims keep running) rather than
blocking.  The JAX lot also debits a leak ledger per park; the port has
no ledger and keeps the lot's own counters.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

__all__ = ["ParkedSeq", "ParkingLot"]


@dataclass
class ParkedSeq:
    """One parked sequence's KV and resume metadata."""

    request_id: str
    k: torch.Tensor      # host [L, n_pages, page, kv_heads, hd], the pool's dtype
    v: torch.Tensor      # same shape as k
    n_pages: int         # pages parked (incl. the partial tail page)
    num_computed: int    # positions whose KV the bytes cover
    kv_rank: int         # pool partition the pages came from (resume target)
    block_hashes: List[int] = field(default_factory=list)  # full blocks


class ParkingLot:
    """Host-side store of parked KV, keyed by request id.

    Thread-safe: park runs on the pump/loop thread, abort-driven discards
    can race from the engine's intake path."""

    def __init__(self, max_pages: int = 0):
        self.max_pages = int(max_pages)
        self._lock = threading.Lock()
        self._entries: Dict[str, ParkedSeq] = {}
        self._pages_held = 0
        # lifetime counters (engine metrics surface them)
        self.parked_total = 0
        self.resumed_total = 0
        self.discarded_total = 0

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def pages_held(self) -> int:
        return self._pages_held

    def can_park(self, n_pages: int) -> bool:
        if self.max_pages <= 0:
            return True
        with self._lock:
            return self._pages_held + n_pages <= self.max_pages

    def park(self, entry: ParkedSeq) -> bool:
        """Store one victim's KV; False when over budget or the request
        is already parked (both leave the lot unchanged)."""
        with self._lock:
            if entry.request_id in self._entries:
                return False
            if (self.max_pages > 0
                    and self._pages_held + entry.n_pages > self.max_pages):
                return False
            self._entries[entry.request_id] = entry
            self._pages_held += entry.n_pages
            self.parked_total += 1
        return True

    def take(self, request_id: str) -> Optional[ParkedSeq]:
        """Remove and return the parked entry for resume (the bytes are
        now the caller's to import)."""
        with self._lock:
            entry = self._entries.pop(request_id, None)
            if entry is None:
                return None
            self._pages_held -= entry.n_pages
            self.resumed_total += 1
        return entry

    def discard(self, request_id: str) -> bool:
        """Drop a parked entry that will never resume (abort / shed /
        shutdown)."""
        with self._lock:
            entry = self._entries.pop(request_id, None)
            if entry is None:
                return False
            self._pages_held -= entry.n_pages
            self.discarded_total += 1
        return True

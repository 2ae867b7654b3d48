"""ActiveSequences — router-side load model of each worker's in-flight work.

The port's copy of the JAX package's `router/sequence.py`.  Tracks, per
worker, the prefill blocks (new compute) and decode blocks (resident KV)
of requests this router sent, so the scheduler's cost function sees load
*before* the worker's next metrics publish (reference
lib/llm/src/kv_router/sequence.rs `ActiveSequences`).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Optional


@dataclass
class _Active:
    worker_id: int
    prefill_blocks: int  # blocks this request must newly compute
    decode_blocks: int  # total blocks resident while decoding
    started: float


class ActiveSequences:
    def __init__(self, expiry_secs: float = 600.0, clock=time.monotonic):
        self._active: Dict[str, _Active] = {}
        self._clock = clock
        self._expiry = expiry_secs

    def add_request(self, request_id: str, worker_id: int,
                    prefill_blocks: int, decode_blocks: int) -> None:
        self._active[request_id] = _Active(
            worker_id, prefill_blocks, decode_blocks, self._clock()
        )

    def mark_prefill_done(self, request_id: str) -> None:
        a = self._active.get(request_id)
        if a:
            a.prefill_blocks = 0

    def free(self, request_id: str) -> None:
        self._active.pop(request_id, None)

    def remove_worker(self, worker_id: int) -> None:
        self._active = {
            r: a for r, a in self._active.items() if a.worker_id != worker_id
        }

    def _expire(self) -> None:
        cutoff = self._clock() - self._expiry
        stale = [r for r, a in self._active.items() if a.started < cutoff]
        for r in stale:
            del self._active[r]

    def load(self, worker_id: int) -> tuple[int, int]:
        """(pending prefill blocks, resident decode blocks) for a worker."""
        self._expire()
        p = d = 0
        for a in self._active.values():
            if a.worker_id == worker_id:
                p += a.prefill_blocks
                d += a.decode_blocks
        return p, d

    def active_count(self, worker_id: Optional[int] = None) -> int:
        if worker_id is None:
            return len(self._active)
        return sum(1 for a in self._active.values() if a.worker_id == worker_id)

"""Conditional disaggregation decision (the port's copy of the JAX
package's `disagg/router.py`): prefill goes remote when the *uncached*
prompt is long enough to be worth the transfer, and prefill capacity
exists."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class DisaggRouter:
    # prompts shorter than this prefill locally (transfer overhead dominates)
    max_local_prefill_length: int = 64
    # a conservative cap: if the prefill queue is deeper than this, do it
    # locally rather than wait
    max_prefill_queue_depth: int = 32

    def should_prefill_remotely(
        self,
        prompt_len: int,
        cached_prefix_len: int,
        prefill_workers_available: bool,
        prefill_queue_depth: int = 0,
    ) -> bool:
        if not prefill_workers_available:
            return False
        if prefill_queue_depth > self.max_prefill_queue_depth:
            return False
        return (prompt_len - cached_prefix_len) > self.max_local_prefill_length

"""The one registry of kernel launches.

Each kernel wrapper adds one to its kernel's entry (`count_launch`) where
it launches it, and nowhere else; the engine's graph runner adds the
launches a capture recorded at every replay.  `chip_smoke.py` zeroes the
registry before it drives a path and reads it after.  "decode_attention"
counts calls of the public function (each a split pass, then a merge
pass), "decode_merge" the merge launches.  "moe_grouped_gemm" counts
calls of the grouped GEMM (with K in slices, a slice pass then a sum
pass), "moe_split_reduce" the sum passes, "moe_grouped_glu" the fused
gate||up launches, "kv_repage" the KV re-page launches of disaggregated
serving (one a transfer, K and V together), "segment_attention" the
vision towers' segment attention, "ring_block" the sequence-parallel
prefill's ring rounds (a cached prefix's fold included) and "ring_finish"
their ends.

Several engines may launch from their own threads in one process (the
data-parallel ranks of a worker), so the counts are taken under a lock,
and a graph capture records its launches per thread (`recording`): what
other threads launch meanwhile stays in the registry.
"""

import threading
from contextlib import contextmanager
from typing import Dict, Iterator

LAUNCHES = {"decode_attention": 0, "decode_merge": 0, "prefill_attention": 0,
            "moe_grouped_gemm": 0, "moe_split_reduce": 0, "moe_grouped_glu": 0,
            "kv_repage": 0, "segment_attention": 0, "ring_block": 0,
            "ring_finish": 0}

_lock = threading.Lock()
_local = threading.local()


def count_launch(name: str, n: int = 1) -> None:
    """Add `n` launches of `name`: to the registry, or to the record of
    the capture this thread is making."""
    record = getattr(_local, "record", None)
    if record is not None:
        record[name] += n
        return
    with _lock:
        LAUNCHES[name] += n


@contextmanager
def recording() -> Iterator[Dict[str, int]]:
    """Count this thread's launches into the yielded dict instead of the
    registry (a graph capture: its kernels run at replay, not now)."""
    _local.record = dict.fromkeys(LAUNCHES, 0)
    try:
        yield _local.record
    finally:
        _local.record = None


def reset_launches() -> None:
    with _lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0

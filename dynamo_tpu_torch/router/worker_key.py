"""Composite worker keys: (instance_id, dp_rank) packed into one int.

The port's copy of the JAX package's `router/worker_key.py`.  The router's
whole pipeline — radix index, ActiveSequences, selector, metrics — keys
by the packed int, and the routing edge unpacks it to (instance for
`client.direct`, dp_rank for the request).  A flat `TorchEngine` worker
serves rank 0; the key layout is the JAX package's, so events and
metrics of port and JAX workers index side by side.
"""

from __future__ import annotations

from typing import Tuple

# ranks per instance bound; packed key = instance_id * DP_RANK_LIMIT + rank
DP_RANK_LIMIT = 1024


def pack_worker(instance_id: int, dp_rank: int = 0) -> int:
    if not 0 <= dp_rank < DP_RANK_LIMIT:
        raise ValueError(f"dp_rank must be in [0, {DP_RANK_LIMIT})")
    return instance_id * DP_RANK_LIMIT + dp_rank


def unpack_worker(key: int) -> Tuple[int, int]:
    return key // DP_RANK_LIMIT, key % DP_RANK_LIMIT

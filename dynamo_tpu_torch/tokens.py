"""Token-sequence block hashing.

TPU-native counterpart of the reference's `dynamo-tokens` crate
(reference lib/tokens/src/lib.rs `compute_block_hash_for_seq`): a
sequence is cut into fixed-size blocks and each block's hash chains the
parent block's hash, so equal hashes imply equal *prefixes* — the invariant
both the engine's prefix cache and the KV-aware router rely on.

Hashes are 64-bit (blake2b-8) and salted: a deployment-wide salt isolates
cache namespaces between models/tenants (reference: sequence hashing w/ salt,
lib/llm/src/block_manager/block.rs).
"""

from __future__ import annotations

import hashlib
import struct
from typing import List, Sequence

BLOCK_HASH_SEED = 1337


def _hash_bytes(data: bytes) -> int:
    return struct.unpack("<Q", hashlib.blake2b(data, digest_size=8).digest())[0]


def chain_seed(salt: str = "") -> int:
    """Root of the hash chain (before any block)."""
    return _hash_bytes(salt.encode()) if salt else BLOCK_HASH_SEED


def next_block_hash(parent: int, block: Sequence[int]) -> int:
    """Extend the chain by one full block."""
    data = struct.pack("<Q", parent) + struct.pack(f"<{len(block)}I", *block)
    return _hash_bytes(data)


def compute_block_hash_for_seq(
    tokens: Sequence[int], block_size: int, salt: str = ""
) -> List[int]:
    """Chained hashes of each *full* block of `tokens`.

    Returns one u64 per full block; a trailing partial block contributes
    nothing (it is not shareable yet).  Pure Python: the same chain the
    JAX package's native hasher computes.
    """
    n_full = len(tokens) // block_size
    hashes: List[int] = []
    parent = chain_seed(salt)
    for i in range(n_full):
        parent = next_block_hash(parent, tokens[i * block_size : (i + 1) * block_size])
        hashes.append(parent)
    return hashes

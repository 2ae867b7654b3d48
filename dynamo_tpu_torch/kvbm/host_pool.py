"""Host-DRAM KV block tier (G2), and the device→host copies that fill it.

The port's copy of the JAX package's `kvbm/host_pool.py`: hash-addressed
blocks under a byte budget with LRU eviction (lookups refresh recency).
A block holds its K and V as host tensors ``[L, page, n_kv, hd]`` in the
pool's own dtype, so a bf16 pool's blocks are bf16 CPU tensors, byte for
byte the device's (numpy has no bf16).  On CUDA the blocks live in
page-locked memory: the engine copies straight between them and the
device, with no staging copy on the host (`chip_smoke.py` phase 9 times
this design against ordinary memory behind one pinned staging buffer).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from itertools import islice
from typing import List, Optional

import torch

__all__ = ["HostBlock", "HostBlockPool", "fetch_blocks", "to_host"]


def to_host(tensors: List[torch.Tensor], ready=None,
            stream=None) -> List[torch.Tensor]:
    """Copy device tensors into fresh host tensors (page-locked on CUDA)
    and wait for the copies.  `ready` is an event the copies must follow
    (the gather that produced the tensors, recorded on another stream);
    `stream` the stream to copy on (default: the current one), which the
    caching allocator is told about so the sources' memory is not handed
    out again before the copies have read it.  CPU tensors are returned
    as they are."""
    if not tensors or tensors[0].device.type != "cuda":
        return list(tensors)
    stream = stream or torch.cuda.current_stream(tensors[0].device)
    out = []
    with torch.cuda.stream(stream):
        if ready is not None:
            stream.wait_event(ready)
        for t in tensors:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            t.record_stream(stream)
            out.append(h)
        done = torch.cuda.Event()
        done.record(stream)
    done.synchronize()
    return out


def fetch_blocks(k: torch.Tensor, v: torch.Tensor, ready=None, stream=None):
    """Per-block host copies of an export: k, v ``[L, n, page, n_kv, hd]``
    on the device → two lists of n contiguous host tensors ``[L, page,
    n_kv, hd]``.  On CUDA the export is made block-major on `stream`
    (after `ready`), then each block is one device→host copy."""
    if k.device.type != "cuda":
        return ([k[:, i].clone() for i in range(k.shape[1])],
                [v[:, i].clone() for i in range(v.shape[1])])
    stream = stream or torch.cuda.current_stream(k.device)
    with torch.cuda.stream(stream):
        if ready is not None:
            stream.wait_event(ready)
        k.record_stream(stream)
        v.record_stream(stream)
        kb = k.transpose(0, 1).contiguous()
        vb = v.transpose(0, 1).contiguous()
    n = k.shape[1]
    flat = to_host(list(kb.unbind(0)) + list(vb.unbind(0)), stream=stream)
    return flat[:n], flat[n:]


@dataclass
class HostBlock:
    block_hash: int
    parent_hash: Optional[int]
    k: torch.Tensor  # [L, page, n_kv, hd]
    v: torch.Tensor

    @property
    def nbytes(self) -> int:
        return self.k.nbytes + self.v.nbytes


class HostBlockPool:
    """hash-addressed host KV store with byte-budget LRU."""

    def __init__(self, capacity_bytes: int = 4 << 30, on_evict=None):
        self.capacity_bytes = capacity_bytes
        # hash → HostBlock, LRU order  # guarded-by: _lock
        self._blocks: "OrderedDict[int, HostBlock]" = OrderedDict()
        self._bytes = 0  # guarded-by: _lock
        self._lock = threading.Lock()
        self.on_evict = on_evict  # callback(HostBlock) — demote to next tier
        self.hits = 0
        self.misses = 0
        self.offloaded = 0
        self.evicted = 0

    def put(self, block_hash: int, parent_hash: Optional[int], k, v) -> None:
        demoted = []
        with self._lock:
            if block_hash in self._blocks:
                self._blocks.move_to_end(block_hash)
                return
            blk = HostBlock(block_hash, parent_hash, k, v)
            self._blocks[block_hash] = blk
            self._bytes += blk.nbytes
            self.offloaded += 1
            while self._bytes > self.capacity_bytes and len(self._blocks) > 1:
                _, old = self._blocks.popitem(last=False)
                self._bytes -= old.nbytes
                self.evicted += 1
                demoted.append(old)
        if self.on_evict:
            for old in demoted:
                self.on_evict(old)

    def get(self, block_hash: int) -> Optional[HostBlock]:
        with self._lock:
            blk = self._blocks.get(block_hash)
            if blk is None:
                self.misses += 1
                return None
            self._blocks.move_to_end(block_hash)
            self.hits += 1
            return blk

    def __contains__(self, block_hash: int) -> bool:
        with self._lock:
            return block_hash in self._blocks

    def __len__(self) -> int:
        with self._lock:
            return len(self._blocks)

    @property
    def bytes_used(self) -> int:
        with self._lock:
            return self._bytes

    def summary(self, max_hashes: int = 8192) -> List[int]:
        """Resident block hashes, most-recently-used first, capped — the
        worker's prefix-summary view of this tier."""
        with self._lock:
            return list(islice(reversed(self._blocks), max_hashes))

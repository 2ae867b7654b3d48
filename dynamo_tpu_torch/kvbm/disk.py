"""Local-disk KV block tier (G3) — one .npz per block hash, byte-capped LRU
(the port's copy of the JAX package's `kvbm/disk.py`).

Writes are ATOMIC (tmp file + rename): the tier directory is shared
across worker processes, and a worker killed mid-offload must never
leave a torn .npz that another worker could onboard — a half-written
block either doesn't exist under its final name, or is complete.  Reads
treat any undecodable file as a miss and drop it.

Blocks are host tensors in the pool's dtype.  numpy has no bf16, so a
file stores each plane as its raw words (a bf16 plane as int16) beside
the dtype's name, and a read views the words back as that dtype: the
round trip is byte-exact for every dtype.  (The JAX tier saves
`ml_dtypes.bfloat16` arrays with `np.savez`, which read back as void
`|V2` arrays with the bits intact.)
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from itertools import islice
from typing import List, Optional, Tuple

import numpy as np
import torch

__all__ = ["DiskTier"]


def _words(t) -> Tuple[np.ndarray, str]:
    """(numpy array of the plane's raw words, dtype name)."""
    if isinstance(t, np.ndarray):
        return t, t.dtype.name
    t = t.detach().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), "bfloat16"
    return t.numpy(), str(t.dtype).removeprefix("torch.")


def _plane(words: np.ndarray, name: str) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(words))
    return t.view(torch.bfloat16) if name == "bfloat16" else t


class DiskTier:
    def __init__(self, root: str, capacity_bytes: int = 32 << 30):
        self.root = root
        self.capacity_bytes = capacity_bytes
        os.makedirs(root, exist_ok=True)
        self._lock = threading.Lock()
        # hash → nbytes  # guarded-by: _lock
        self._index: "OrderedDict[int, int]" = OrderedDict()
        # hashes whose bytes THIS process wrote or read back successfully.
        # Startup-scan / _discover entries stay unverified: they may be
        # torn debris under a valid final name, so put() must overwrite
        # them (os.replace is atomic) rather than dedup against them, and
        # the offload drain must not skip the host insert on their account
        self._verified: set = set()  # guarded-by: _lock
        self._bytes = 0  # guarded-by: _lock
        self.hits = 0
        self.misses = 0
        for name in os.listdir(root):
            if name.startswith(".tmp-"):
                # write debris of a killed writer: invisible to the index
                # and the byte cap, so sweep it — age-gated so a LIVE
                # writer's in-progress tmp is never swept
                p = os.path.join(root, name)
                try:
                    if time.time() - os.path.getmtime(p) > 60:
                        os.remove(p)
                except OSError:
                    pass
                continue
            if name.endswith(".npz"):
                try:
                    h = int(name[:-4], 16)
                except ValueError:
                    continue
                sz = os.path.getsize(os.path.join(root, name))
                self._index[h] = sz
                self._bytes += sz

    def _path(self, block_hash: int) -> str:
        return os.path.join(self.root, f"{block_hash:016x}.npz")

    def put(self, block_hash: int, parent_hash: Optional[int], k, v) -> None:
        with self._lock:
            if block_hash in self._index and block_hash in self._verified:
                self._index.move_to_end(block_hash)
                return
        # file I/O outside the lock; atomic publish: savez to a private tmp
        # name (pid + thread: two threads may race one hash), then rename
        path = self._path(block_hash)
        tmp = os.path.join(
            self.root,
            f".tmp-{os.getpid()}-{threading.get_ident()}"
            f"-{block_hash:016x}.npz",
        )
        kw, name = _words(k)
        vw, _ = _words(v)
        try:
            np.savez(
                tmp, k=kw, v=vw, dtype=np.array(name),
                parent=np.uint64(
                    parent_hash if parent_hash is not None
                    else (1 << 64) - 1
                ),
            )
            os.replace(tmp, path)
            sz = os.path.getsize(path)
        except Exception:  # any savez failure must not leak the tmp
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise
        evicted: List[int] = []
        with self._lock:
            self._bytes -= self._index.get(block_hash, 0)  # debris replaced
            self._index[block_hash] = sz
            self._verified.add(block_hash)
            self._bytes += sz
            while self._bytes > self.capacity_bytes and len(self._index) > 1:
                old, old_sz = self._index.popitem(last=False)
                self._bytes -= old_sz
                self._verified.discard(old)
                evicted.append(old)
        for old in evicted:
            # unlink outside the lock; a concurrent put() may have
            # re-published this hash since eviction chose it
            with self._lock:
                if old in self._index:
                    continue
            try:
                os.remove(self._path(old))
            except OSError:
                pass

    def _discover_locked(self, block_hash: int) -> bool:
        """Index miss → check the filesystem: the tier directory is SHARED
        across workers, so another process may have written the block
        after our directory scan.  Caller holds the lock."""
        try:
            sz = os.path.getsize(self._path(block_hash))
        except OSError:
            return False
        self._index[block_hash] = sz
        self._bytes += sz
        return True

    def get(self, block_hash: int) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        with self._lock:
            if block_hash not in self._index and not self._discover_locked(block_hash):
                self.misses += 1
                return None
            self._index.move_to_end(block_hash)
        path = self._path(block_hash)
        torn_stat = None
        try:
            torn_stat = os.stat(path)
            with np.load(path) as z:
                # materialize BEFORE counting the hit: a valid zip that
                # lacks the arrays (foreign debris) raises KeyError here
                name = str(z["dtype"])
                k, v = _plane(z["k"], name), _plane(z["v"], name)
            self.hits += 1
            with self._lock:
                self._verified.add(block_hash)
            return k, v
        except Exception:  # noqa: BLE001 — torn/corrupt file = miss
            # drop the undecodable block, but only if the file is still
            # the one we failed to read (inode+mtime): a concurrent put()
            # may have atomically re-published a VALID block since
            with self._lock:
                sz = self._index.pop(block_hash, 0)
                self._bytes -= sz
                self._verified.discard(block_hash)
                try:
                    st = os.stat(path)
                    if (torn_stat is not None
                            and (st.st_ino, st.st_mtime_ns)
                            == (torn_stat.st_ino, torn_stat.st_mtime_ns)):
                        os.remove(path)
                except OSError:
                    pass
            self.misses += 1
            return None

    def __contains__(self, block_hash: int) -> bool:
        with self._lock:
            return block_hash in self._index or self._discover_locked(block_hash)

    def has_verified(self, block_hash: int) -> bool:
        """True only for entries whose bytes this process wrote or read
        back successfully — the offload drain's dedup signal."""
        with self._lock:
            return block_hash in self._verified and block_hash in self._index

    def __len__(self) -> int:
        with self._lock:
            return len(self._index)

    @property
    def bytes_used(self) -> int:
        with self._lock:
            return self._bytes

    def summary(self, max_hashes: int = 8192) -> List[int]:
        """Indexed block hashes, most-recently-used first, capped — the
        worker's published prefix-summary view of this tier."""
        with self._lock:
            # O(max_hashes), not O(index): the publisher calls this every
            # tick and the drain thread's demotion writes contend the lock
            return list(islice(reversed(self._index), max_hashes))

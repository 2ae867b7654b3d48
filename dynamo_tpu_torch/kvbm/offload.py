"""TieredKvCache — the offload/onboard manager gluing the engine's device
page pool (G1) to host DRAM (G2), disk (G3) and the control plane's
object store (G4); the port's copy of the JAX package's `kvbm/offload.py`.

- The offload pump is SPLIT across two threads so the device-step thread
  never blocks on a host copy: the step thread (between steps) only
  launches the gather of the queued blocks' pages and records a CUDA
  event behind it; the ``kvbm-offload`` drain thread waits for that
  event on a copy stream of its own, copies the blocks device→host there
  (overlapping the next steps), and inserts them into the host pool.
- Demotion happens on host-LRU eviction (write-back), to disk (G3) when
  there is one, else to the object store (G4), on whichever thread
  inserted into the host pool: the drain thread for offloads, the
  admitting thread for promotions.
- Onboarding runs inside admission: after the device prefix-cache lookup
  the remaining hash run is looked up host first, then disk, then the
  object store (promoting to host), imported into freshly allocated device pages, and committed so
  the device cache (and KV-event subscribers) see them.
"""

from __future__ import annotations

import logging
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Tuple

import torch

from .disk import DiskTier
from .host_pool import HostBlock, HostBlockPool, fetch_blocks

logger = logging.getLogger(__name__)

__all__ = ["TieredKvCache"]


class TieredKvCache:
    def __init__(self, host: HostBlockPool, disk: Optional[DiskTier] = None,
                 remote=None, max_offload_batch: int = 16):
        self.host = host
        self.disk = disk
        self.remote = remote  # G4: kvbm.remote.ObjectStoreTier (shared)
        self.max_offload_batch = max_offload_batch
        # (hash, parent) queue  # guarded-by: _lock
        self._pending: List[Tuple[int, Optional[int]]] = []
        self._lock = threading.Lock()
        # hashes whose device→host copy is in flight on the drain thread
        # (gather launched, host insert not yet done) — they must not be
        # re-exported by the next pump tick  # guarded-by: _lock
        self._inflight: set[int] = set()
        # ONE drain thread: host inserts stay ordered, and demotion disk
        # writes serialize instead of thrashing a shared tier directory
        self._drain = self._new_drain()
        self._copy_stream = None  # the drain's CUDA stream, made on first use
        self.onboarded_blocks = 0
        self.offloaded_blocks = 0
        if disk is not None or remote is not None:
            host.on_evict = self._demote

    @staticmethod
    def _new_drain() -> ThreadPoolExecutor:
        return ThreadPoolExecutor(max_workers=1,
                                  thread_name_prefix="kvbm-offload")

    def _demote(self, blk: HostBlock) -> None:
        """Write-back demotion: host-evicted blocks land on disk (G3) when
        present, else the object store (G4)."""
        tier = self.disk if self.disk is not None else self.remote
        try:
            tier.put(blk.block_hash, blk.parent_hash, blk.k, blk.v)
        except OSError as e:
            logger.warning("tier demotion failed: %s", e)

    # -- engine event sink (any thread) -------------------------------------- #

    def on_event(self, ev) -> None:
        if ev.kind != "stored":
            return
        parent = ev.parent_hash
        with self._lock:
            for h in ev.block_hashes:
                self._pending.append((h, parent))
                parent = h

    # -- offload pump (engine step thread, between steps) --------------------- #

    def pump_offloads(self, engine) -> int:
        """Launch one batch of queued device→host copies.  Runs on the
        engine's step thread strictly BETWEEN steps, and only launches
        the gather (and records an event behind it on the step's stream):
        the copy to the host and the host-pool insert complete on the
        ``kvbm-offload`` drain thread.  Returns blocks dispatched."""
        with self._lock:
            # backpressure: each dispatched chunk pins fresh device export
            # buffers until its copy completes; cap in-flight at 2 batches
            if len(self._inflight) >= 2 * self.max_offload_batch:
                return 0
            batch = self._pending[: self.max_offload_batch]
            self._pending = self._pending[self.max_offload_batch:]
            # step-thread dedup is IN-MEMORY only (inflight set + host
            # dict); disk and object-store membership (a stat, a bucket
            # listing) is checked on the drain thread.  The batch moves from _pending to _inflight inside
            # one locked section, so offload_backlog never reads 0 while
            # a dispatch is being prepared
            todo = [
                (h, p) for h, p in batch
                if h not in self._inflight and h not in self.host
            ]
            self._inflight.update(h for h, _ in todo)
        if not todo:
            return 0
        parents = dict(todo)
        try:
            chunks = engine.export_cached_blocks_device(
                [h for h, _ in todo])
            chunks = [(hs, k, v, _ready_event(k)) for hs, k, v in chunks]
        except BaseException:
            with self._lock:
                self._inflight.difference_update(h for h, _ in todo)
            raise
        resolved = {h for hs, _, _, _ in chunks for h in hs}
        stale = [h for h, _ in todo if h not in resolved]
        if stale:  # no longer device-cached — nothing will drain them
            with self._lock:
                self._inflight.difference_update(stale)
        n = len(resolved)
        if not n:
            return 0
        try:
            self._drain.submit(self._complete_offload, chunks, parents)
        except RuntimeError:
            # close()d by a previous owner's shutdown and re-attached to a
            # new engine: reopen the drain lazily
            self._drain = self._new_drain()
            self._drain.submit(self._complete_offload, chunks, parents)
        return n

    def _complete_offload(self, chunks, parents) -> None:
        """Drain-thread half: device→host copy after the gather's event
        (on this thread's own stream) + host insert (and, via the host
        pool's on_evict, any G2→G3 demotion writes)."""
        try:
            for hashes, k_dev, v_dev, ready in chunks:
                ks, vs = fetch_blocks(k_dev, v_dev, ready,
                                      self._stream_for(k_dev.device))
                for i, h in enumerate(hashes):
                    # lower-tier dedup lives HERE (not the step thread):
                    # membership may stat a shared dir or ask the control
                    # plane.  Disk dedup trusts only VERIFIED entries — a
                    # discovered-but-unread file may be torn debris
                    if ((self.disk is not None and self.disk.has_verified(h))
                            or (self.remote is not None and h in self.remote)):
                        continue
                    self.host.put(h, parents.get(h), ks[i], vs[i])
                    self.offloaded_blocks += 1
        except Exception:  # noqa: BLE001 — offload is best-effort
            logger.exception("kvbm offload drain failed")
        finally:
            with self._lock:
                for hashes, _, _, _ in chunks:
                    self._inflight.difference_update(hashes)

    def _stream_for(self, device: torch.device):
        if device.type != "cuda":
            return None
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(device)
        return self._copy_stream

    @property
    def pending_offloads(self) -> int:
        """Queued blocks still needing a device-side gather (step-thread
        work) — the engine's chain fall-out / pump gating signal."""
        with self._lock:
            return len(self._pending)

    @property
    def inflight_offloads(self) -> int:
        """Blocks whose gather is launched but whose host copy hasn't
        completed on the drain thread yet."""
        with self._lock:
            return len(self._inflight)

    @property
    def offload_backlog(self) -> int:
        """pending + in-flight — zero means every queued block has landed
        in a host/disk tier (what tests and drain barriers wait on)."""
        with self._lock:
            return len(self._pending) + len(self._inflight)

    def close(self) -> None:
        """Join the drain thread (no tier write outlives the caller).  A
        tier re-attached to a later engine reopens the drain lazily on
        the next pump dispatch; the G4 loop thread has the same
        lazy-reopen contract, so it is closed here too."""
        self._drain.shutdown(wait=True)
        if self.remote is not None:
            self.remote.close()

    # -- onboarding (admission path) ----------------------------------------- #

    def lookup_run(self, hashes: Sequence[int]) -> List[HostBlock]:
        """Leading run across host → disk → object store (G2→G3→G4);
        lower-tier hits are promoted to host."""
        out: List[HostBlock] = []
        for h in hashes:
            blk = self.host.get(h)
            if blk is None:
                for tier in (self.disk, self.remote):
                    if tier is None:
                        continue
                    kv = tier.get(h)
                    if kv is not None:
                        parent = out[-1].block_hash if out else None
                        self.host.put(h, parent, kv[0], kv[1])
                        blk = self.host.get(h)
                        break
            if blk is None:
                break
            out.append(blk)
        return out

    def onboard(self, engine, hashes: Sequence[int], rank: int = 0,
                headroom: Optional[int] = None) -> List[int]:
        """Import the leading cached run into device pages; returns page
        ids committed to the device prefix cache.  ``headroom`` pages are
        left free (callers pass the admission watermark so onboarding
        never eats the reserve `_admit_check` holds back for decode
        growth)."""
        run = self.lookup_run(hashes)
        free = max(0, engine.pool.available_on(rank)
                   - (2 if headroom is None else headroom))
        run = run[:free]
        pages = engine.import_committed_blocks(
            [(b.block_hash, b.parent_hash, b.k, b.v) for b in run],
            rank=rank,
        )
        self.onboarded_blocks += len(pages)
        return pages

    # -- router-facing tier summary ------------------------------------------- #

    def summary(self, max_hashes: int = 8192) -> dict:
        """Per-tier block-hash lists for the worker's published prefix
        summary (most-recent first, capped) — what the router's global
        index scores tier overlap against."""
        host = self.host.summary(max_hashes)
        disk = (self.disk.summary(max_hashes)
                if self.disk is not None else [])
        return {"host": host, "disk": disk}


def _ready_event(t: torch.Tensor):
    """An event behind the work that produced `t` on the current stream
    (None on the CPU, where it is already done)."""
    if t.device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(t.device))
    return ev

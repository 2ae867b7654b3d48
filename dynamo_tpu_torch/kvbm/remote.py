"""G4 — remote KV tier over the control plane's object store.

The port's copy of the JAX package's `kvbm/remote.py`.  The reference's
G4 is a remote storage level below local NVMe (block_manager.rs
`CacheLevel::G4`).  Here it is the control-plane object store (the
NATS-object-store analog): blocks keyed by hash in a shared bucket, so
every worker in the deployment sees every other worker's demoted blocks —
the tier that makes KVBM *distributed* rather than per-process.

Tier calls are synchronous and may come from either the offload drain
thread (demotion) or the event-loop thread (admission-time onboarding),
so the tier runs its OWN event loop on a daemon thread with its own
control-plane connection — blocking the caller never deadlocks the
runtime's loop.

A blob is the port's `wire.pack` of ``{parent, dtype, shape, k, v}`` with
the planes' raw bytes (a bf16 plane as its 16-bit words, dtype
``"bfloat16"``): the JAX package's msgpack blob, byte for byte.
"""

from __future__ import annotations

import asyncio
import logging
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from ..runtime.transport.wire import pack, unpack
from .disk import _plane, _words

logger = logging.getLogger(__name__)

__all__ = ["ObjectStoreTier"]


class ObjectStoreTier:
    def __init__(self, control_address: str, bucket: str = "kvbm-g4",
                 timeout: float = 5.0):
        self.control_address = control_address
        self.bucket = bucket
        self.timeout = timeout
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._client = None
        # names known to exist in the bucket (local view; cross-process
        # uploads are discovered on get) — makes `in` cheap and dedups puts
        self._known: set[str] = set()
        self._listed = False
        self._started = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._ensure_loop()

    def _ensure_loop(self) -> None:
        """Start (or restart after close()) the tier's loop thread — the
        same lazy-reopen contract as TieredKvCache's drain executor, so
        a tier re-attached to a later engine keeps working."""
        if self._thread is not None and self._thread.is_alive():
            return
        self._started.clear()
        self._thread = threading.Thread(
            target=self._loop_main, name="kvbm-g4", daemon=True
        )
        self._thread.start()
        self._started.wait(self.timeout)

    def _loop_main(self) -> None:
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)
        self._started.set()
        self._loop.run_forever()

    async def _get_client(self):
        if self._client is None:
            from ..runtime.transport.control_plane import ControlPlaneClient

            self._client = await ControlPlaneClient(self.control_address).connect()
        return self._client

    def _run(self, coro_fn):
        self._ensure_loop()

        async def wrapped():
            client = await self._get_client()
            return await coro_fn(client)

        return asyncio.run_coroutine_threadsafe(wrapped(), self._loop).result(
            self.timeout
        )

    def close(self) -> None:
        """Stop the loop and JOIN the thread: no tier I/O outlives the
        caller, and the kvbm-g4 thread doesn't leak per lifecycle.  A
        later call re-opens the loop lazily (`_ensure_loop`)."""
        if self._loop is not None:
            if self._client is not None:
                asyncio.run_coroutine_threadsafe(
                    self._client.close(), self._loop
                ).result(2.0)
                self._client = None
            self._loop.call_soon_threadsafe(self._loop.stop)
            self._loop = None
        if self._thread is not None:
            self._thread.join(self.timeout)
            self._thread = None

    @staticmethod
    def _name(block_hash: int) -> str:
        return format(block_hash & (2**64 - 1), "016x")

    def put(self, block_hash: int, parent_hash: Optional[int],
            k: torch.Tensor, v: torch.Tensor) -> None:
        name = self._name(block_hash)
        if name in self._known:
            return
        kw, dtype = _words(k)
        vw, _ = _words(v)
        blob = pack({
            "parent": parent_hash,
            "dtype": dtype,
            "shape": list(kw.shape),
            "k": kw.tobytes(),
            "v": vw.tobytes(),
        })
        try:
            self._run(lambda c: c.obj_put(self.bucket, name, blob))
            self._known.add(name)
        except Exception as e:  # noqa: BLE001 — G4 is best-effort
            logger.warning("G4 put failed for %x: %r", block_hash, e)

    def get(self, block_hash: int) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        try:
            blob = self._run(
                lambda c: c.obj_get(self.bucket, self._name(block_hash))
            )
        except Exception as e:  # noqa: BLE001
            logger.warning("G4 get failed for %x: %r", block_hash, e)
            return None
        if blob is None:
            return None
        self._known.add(self._name(block_hash))
        d = unpack(blob)
        name = d["dtype"]
        words = np.dtype(np.int16 if name == "bfloat16" else name)
        shape = tuple(d["shape"])
        return tuple(
            _plane(np.frombuffer(d[p], words).reshape(shape).copy(), name)
            for p in ("k", "v"))

    def __contains__(self, block_hash: int) -> bool:
        # containment gates duplicate offloads; a racy false negative just
        # re-uploads an identical blob.  One bucket listing seeds the local
        # view; afterwards membership is the cheap local set.
        if not self._listed:
            try:
                self._known.update(self._run(lambda c: c.obj_list(self.bucket)))
                self._listed = True
            except Exception:  # noqa: BLE001
                return False
        return self._name(block_hash) in self._known

"""Distributed KVBM bootstrap: leader/worker layout exchange + barrier (the
port's copy of the JAX package's `kvbm/distributed.py`).

The exchange rides the control plane's KV primitives.  Protocol under
``/kvbm/{namespace}``:

- leader puts  ``…/config``            — tier config (disk root, G4
                                         bucket, host bytes), lease-scoped
- worker puts  ``…/workers/{lease}``   — its KV layout, lease-scoped
- leader puts  ``…/ready``             — member list once `world` workers
                                         registered with IDENTICAL layouts
                                         (the barrier release)

Workers that see ``ready`` containing their id build a TieredKvCache whose
disk tier points at the SHARED root (and whose G4 tier at the SHARED
object-store bucket) and attach it to their engine — so any worker
onboards blocks any other worker demoted.  The layout and the
config are the JAX package's, key for key, so port and JAX workers can
share one barrier (and a layout mismatch between them is refused).
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from ..disagg.transfer import KvLayout
from ..runtime.transport.wire import pack, unpack
from .disk import DiskTier
from .host_pool import HostBlockPool
from .offload import TieredKvCache
from .remote import ObjectStoreTier

logger = logging.getLogger(__name__)

__all__ = ["KvLayout", "KvbmConfig", "KvbmLeader", "KvbmWorker"]

PREFIX = "/kvbm"


@dataclass
class KvbmConfig:
    disk_root: Optional[str] = None  # shared G3 directory (None = no disk)
    g4_bucket: Optional[str] = None  # shared G4 object-store bucket
    host_bytes: int = 1 << 30
    disk_bytes: int = 32 << 30

    def to_dict(self) -> Dict[str, Any]:
        return {
            "disk_root": self.disk_root,
            "g4_bucket": self.g4_bucket,
            "host_bytes": self.host_bytes,
            "disk_bytes": self.disk_bytes,
        }


class KvbmLeader:
    """Publishes tier config, barriers the worker set, verifies layouts."""

    def __init__(self, runtime, config: KvbmConfig, world: int,
                 namespace: str = "dynamo"):
        self.runtime = runtime
        self.config = config
        self.world = world
        self.ns = namespace
        self.members: List[str] = []

    async def start(self, timeout: float = 60.0) -> "KvbmLeader":
        c = self.runtime.control
        await self.runtime.put_leased(
            f"{PREFIX}/{self.ns}/config", pack(self.config.to_dict())
        )
        deadline = time.monotonic() + timeout
        prefix = f"{PREFIX}/{self.ns}/workers/"
        layouts: Dict[str, dict] = {}
        while True:
            rows = await c.get_prefix(prefix)
            layouts = {k[len(prefix):]: unpack(v) for k, v in rows}
            if len(layouts) >= self.world:
                break
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"kvbm barrier: {len(layouts)}/{self.world} workers "
                    f"after {timeout}s"
                )
            await asyncio.sleep(0.1)
        # layouts must agree exactly — the shared tiers store raw block
        # arrays, so a single geometry governs the whole deployment
        distinct = {tuple(sorted(d.items())) for d in layouts.values()}
        if len(distinct) != 1:
            raise ValueError(f"kvbm layout mismatch across workers: {layouts}")
        self.members = sorted(layouts)
        await self.runtime.put_leased(
            f"{PREFIX}/{self.ns}/ready", pack({"members": self.members})
        )
        logger.info("kvbm leader: %d workers barriered", len(self.members))
        return self


class KvbmWorker:
    """Registers the engine's layout, waits for the barrier, builds the
    shared-tier cache and attaches it to the engine."""

    def __init__(self, runtime, engine, namespace: str = "dynamo"):
        self.runtime = runtime
        self.engine = engine
        self.ns = namespace
        self.worker_id = str(runtime.primary_lease)
        self.tiered: Optional[TieredKvCache] = None

    async def start(self, timeout: float = 60.0) -> TieredKvCache:
        c = self.runtime.control
        deadline = time.monotonic() + timeout
        # 1. wait for the leader's config
        while True:
            raw = await c.get(f"{PREFIX}/{self.ns}/config")
            if raw is not None:
                cfg = unpack(raw)
                break
            if time.monotonic() > deadline:
                raise TimeoutError("kvbm: no leader config")
            await asyncio.sleep(0.1)
        # 2. register our layout
        layout = KvLayout.of_engine(self.engine).to_dict()
        await self.runtime.put_leased(
            f"{PREFIX}/{self.ns}/workers/{self.worker_id}", pack(layout)
        )
        # 3. barrier: wait until the leader lists us as a member
        while True:
            raw = await c.get(f"{PREFIX}/{self.ns}/ready")
            if raw is not None and self.worker_id in unpack(raw)["members"]:
                break
            if time.monotonic() > deadline:
                raise TimeoutError("kvbm: barrier not released")
            await asyncio.sleep(0.1)
        # 4. build tiers against the SHARED roots
        disk = (
            DiskTier(cfg["disk_root"], capacity_bytes=cfg["disk_bytes"])
            if cfg.get("disk_root") else None
        )
        remote = (
            ObjectStoreTier(self.runtime.control_address, cfg["g4_bucket"])
            if cfg.get("g4_bucket") else None
        )
        self.tiered = TieredKvCache(
            HostBlockPool(capacity_bytes=cfg["host_bytes"]),
            disk=disk, remote=remote,
        )
        self.engine.attach_connector(self.tiered)
        logger.info("kvbm worker %s attached (disk=%s g4=%s)",
                    self.worker_id, cfg.get("disk_root"), cfg.get("g4_bucket"))
        return self.tiered

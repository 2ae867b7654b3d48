"""KVBM — KV off the device: the preemption parking lot and the multi-tier
KV block manager (device HBM → host DRAM → disk), with a leader/worker
bootstrap for workers sharing the lower tiers, the object-store tier (G4)
and the tier-summary publisher the KV router scores.  The port's copy of
the JAX package's `kvbm/`."""

from .disk import DiskTier
from .distributed import KvbmConfig, KvbmLeader, KvbmWorker, KvLayout
from .host_pool import HostBlock, HostBlockPool
from .offload import TieredKvCache
from .park import ParkedSeq, ParkingLot
from .remote import ObjectStoreTier
from .summary import TierSummaryPublisher, summary_key, summary_prefix

__all__ = [
    "DiskTier",
    "HostBlock",
    "HostBlockPool",
    "KvLayout",
    "KvbmConfig",
    "KvbmLeader",
    "KvbmWorker",
    "ObjectStoreTier",
    "ParkedSeq",
    "ParkingLot",
    "TierSummaryPublisher",
    "TieredKvCache",
    "summary_key",
    "summary_prefix",
]

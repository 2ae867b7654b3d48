"""KVBM — KV off the device: the preemption parking lot and the multi-tier
KV block manager (device HBM → host DRAM → disk), with a leader/worker
bootstrap for workers sharing the lower tiers.  The port's copy of the
JAX package's `kvbm/`; its object-store tier (G4) and tier-summary
publisher come with the KV router."""

from .disk import DiskTier
from .distributed import KvbmConfig, KvbmLeader, KvbmWorker, KvLayout
from .host_pool import HostBlock, HostBlockPool
from .offload import TieredKvCache
from .park import ParkedSeq, ParkingLot

__all__ = [
    "DiskTier",
    "HostBlock",
    "HostBlockPool",
    "KvLayout",
    "KvbmConfig",
    "KvbmLeader",
    "KvbmWorker",
    "ParkedSeq",
    "ParkingLot",
    "TieredKvCache",
]

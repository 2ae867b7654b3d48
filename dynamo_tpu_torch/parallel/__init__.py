"""Tensor parallelism of the port over `torch.distributed`: the group
(`mesh.py`), the shard axes and each rank's shard (`sharding.py`), and
the collectives (`collectives.py`).  `TorchEngine(parallel=
ParallelConfig(tp=N))` serves on such a group, its leader replaying every
device step on the followers (`engine/lockstep.py`)."""

from .mesh import ParallelConfig, TpGroup, check_ported, make_mesh
from .sharding import (
    CheckpointShards,
    SeededShards,
    TreeShards,
    check_divisible,
    kv_shard_heads,
    param_shard_axes,
    shard_params,
)

__all__ = [
    "CheckpointShards",
    "ParallelConfig",
    "SeededShards",
    "TpGroup",
    "TreeShards",
    "check_divisible",
    "check_ported",
    "kv_shard_heads",
    "make_mesh",
    "param_shard_axes",
    "shard_params",
]

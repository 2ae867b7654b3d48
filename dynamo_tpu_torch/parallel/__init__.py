"""Data, pipeline and tensor parallelism of the port over
`torch.distributed`: the group (`mesh.py`), the shard axes and each
rank's shard of its stage's layers (`sharding.py`), the collectives and
the stage handoffs (`collectives.py`), and the pipeline's tick loops
(`pipeline.py`).  `TorchEngine(parallel=ParallelConfig(dp, pp, tp))`
serves on such a group, its leader replaying every device step on the
followers (`engine/lockstep.py`)."""

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

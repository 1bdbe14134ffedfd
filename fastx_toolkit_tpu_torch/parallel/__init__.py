from . import multihost  # noqa: F401
from .mesh import (  # noqa: F401
    data_mesh,
    shard_batch,
    sharded_stats,
    sharded_pipeline,
    sharded_packed_pipeline,
    distributed_init,
)

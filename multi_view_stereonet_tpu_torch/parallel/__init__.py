"""Multi-process training: the process group, per-process dataset shards, and the
``(data, view)`` process grid whose reductions give the global batch's losses and
gradients."""

from .distributed import (
    ShardedDataset, initialize, is_main_process, join, local_shard_indices, process_count,
    process_index, shutdown)
from .mesh import (
    ProcessMesh, ViewGroupFeed, batch_mean, batch_sums, make_process_mesh, reducing_over,
    view_mean)

__all__ = ["ShardedDataset", "initialize", "is_main_process", "join",
           "local_shard_indices", "process_count", "process_index", "shutdown",
           "ProcessMesh", "batch_mean", "batch_sums", "make_process_mesh", "reducing_over",
           "view_mean", "ViewGroupFeed"]

"""Data sharding across processes: the strided per-process view of a dataset."""

from .distributed import ShardedDataset

__all__ = ["ShardedDataset"]

"""Per-process dataset shards.

Port of ``ShardedDataset`` (``multi_view_stereonet_tpu/parallel/distributed.py:122-153``).
The caller names its shard: the port reads no cluster state, so
``process_id`` and ``process_count`` are required.
"""

from __future__ import annotations


class ShardedDataset:
    """View of a dataset restricted to one process's samples: indices
    ``process_id, process_id + process_count, ...``.

    Strided rather than contiguous, so every process sees samples from the
    whole split even when the split file is ordered by sequence. The shards
    cover every sample once (fleet-sharded streaming inference, which has
    no collectives); the JAX package's ``drop_ragged_tail`` for training's
    equal step counts comes with the training port.
    """

    def __init__(self, dataset, process_id: int, process_count: int):
        if not 0 <= process_id < process_count:
            raise ValueError(f"process_id {process_id} must be in [0, {process_count})")
        self._dataset = dataset
        self._indices = list(range(process_id, len(dataset), process_count))

    def __len__(self):
        return len(self._indices)

    def __getitem__(self, idx):
        return self._dataset[self._indices[idx]]

    def __getattr__(self, name):  # passthrough (e.g. .samples metadata)
        return getattr(self._dataset, name)

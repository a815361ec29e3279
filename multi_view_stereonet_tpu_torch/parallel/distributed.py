"""Multi-process training: joining the process group, and per-process dataset shards.

Port of ``multi_view_stereonet_tpu/parallel/distributed.py``. The JAX package runs
one process per host that drives all of that host's devices; the port runs one
process per card, PyTorch's idiom:

- :func:`initialize` joins ``torch.distributed`` over a ``tcp://`` store on the
  coordinator (process 0's ``host:port``), with a finite timeout, so that a process
  that dies fails the others' next collective instead of hanging them. It is a
  no-op for a single process, which then launches no collective at all.
- The backend is decided from the devices: NCCL where each process has a card of
  its own, gloo on the CPU and where processes share a card (NCCL refuses two
  ranks on one device). Each process takes card ``local rank % card count``, its
  local rank being its index among the processes on its host.
- Each process loads its strided shard of the split (:class:`ShardedDataset`);
  ``parallel/mesh.py`` arranges the processes as the JAX package's ``(data, view)``
  mesh and reduces the losses and gradients over it.
"""

from __future__ import annotations

import datetime
import os
import socket

import torch
import torch.distributed as dist

ENV_COORDINATOR = "MVS_COORDINATOR_ADDRESS"
ENV_NUM_PROCESSES = "MVS_NUM_PROCESSES"
ENV_PROCESS_ID = "MVS_PROCESS_ID"
# Every collective and the store's rendezvous wait at most this long: a rank that
# raised, or left the loop alone, fails the others instead of hanging them. It must
# outlast what the others wait out in their next collective: process 0's validation
# and checkpoint at the end of an epoch.
TIMEOUT = datetime.timedelta(minutes=30)

# The processes on this host of the group this process joined.
_local_processes = 1


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, device=None) -> bool:
    """Join the multi-process group; a no-op for a single process.

    The arguments default to the ``MVS_COORDINATOR_ADDRESS`` / ``MVS_NUM_PROCESSES``
    / ``MVS_PROCESS_ID`` environment variables. ``device`` is the entry point's:
    "cpu" trains on the CPU over gloo; otherwise each process takes a card (see
    :func:`join`). Returns True if a multi-process group was joined."""
    coordinator_address = coordinator_address or os.environ.get(ENV_COORDINATOR)
    if not coordinator_address:
        return False
    if num_processes is None:
        num_processes = int(os.environ[ENV_NUM_PROCESSES])
    if process_id is None:
        process_id = int(os.environ[ENV_PROCESS_ID])
    if num_processes == 1:
        return False
    join(coordinator_address, num_processes, process_id, device)
    return True


def join(coordinator_address: str, num_processes: int, process_id: int,
         device=None) -> torch.device:
    """Join a group of ``num_processes`` at ``coordinator_address`` ("host:port", the
    store that process 0 opens) as ``process_id``, at any size (``initialize`` calls
    it for more than one process). Returns this process's device: the CPU for
    ``device`` "cpu", else card ``local rank % card count``, made current. NCCL where
    this host has no more processes than cards, gloo otherwise. Unless
    ``OMP_NUM_THREADS`` is set, each process takes its share of the host's intra-op
    threads."""
    global _local_processes
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} must be in [0, {num_processes})")
    host, port = coordinator_address.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), num_processes, is_master=process_id == 0,
                          timeout=TIMEOUT)
    store.set(f"host/{process_id}", socket.gethostname())
    hosts = [store.get(f"host/{rank}").decode() for rank in range(num_processes)]
    peers = [rank for rank, h in enumerate(hosts) if h == hosts[process_id]]
    local_rank, local_size = peers.index(process_id), len(peers)

    on_cpu = torch.device("cuda" if device is None else device).type == "cpu"
    if on_cpu:
        backend, dev = "gloo", torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("this runs on CUDA cards and the process has none: pass "
                               "device='cpu' to train on the CPU")
        cards = torch.cuda.device_count()
        dev = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(dev)
        backend = "nccl" if local_size <= cards else "gloo"
    if "OMP_NUM_THREADS" not in os.environ:
        # The host's intra-op threads shared among its processes (torchrun sets one a
        # process): with every process at the default, their OpenMP threads spin
        # against each other, and a step on the CPU took 60 times as long.
        torch.set_num_threads(max(1, torch.get_num_threads() // local_size))
    dist.init_process_group(backend, store=store, rank=process_id,
                            world_size=num_processes, timeout=TIMEOUT)
    _local_processes = local_size
    if process_id == 0:
        cards = "the CPU" if on_cpu else f"{torch.cuda.device_count()} card(s) a host"
        print(f"process group: {num_processes} processes over {backend} ({local_size} on "
              f"this host, {cards}; NCCL needs a card per process); process 0 on {dev}",
              flush=True)
    return dev


def shutdown():
    """Leave the process group, if this process joined one."""
    global _local_processes
    if dist.is_initialized():
        dist.destroy_process_group()
    _local_processes = 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_process_count() -> int:
    """The processes of the group on this process's host."""
    return _local_processes if dist.is_initialized() else 1


def is_main_process() -> bool:
    """True on the process that owns logging, plots, checkpoints and validation."""
    return process_index() == 0


def local_shard_indices(n_samples: int, process_id: int | None = None,
                        num_processes: int | None = None) -> list[int]:
    """This process's strided shard of ``range(n_samples)``: ``process_id::count``."""
    if process_id is None:
        process_id = process_index()
    if num_processes is None:
        num_processes = process_count()
    return list(range(process_id, n_samples, num_processes))


class ShardedDataset:
    """View of a dataset restricted to one process's samples: indices
    ``process_id, process_id + num_processes, ...`` (by default this process's place
    in the group).

    Strided rather than contiguous, so every process sees samples from the whole
    split even when the split file is ordered by sequence. With ``drop_ragged_tail``
    (the default) every process has ``floor(n / num_processes)`` samples, so all run
    the same number of steps: a process with one more would wait in a collective
    that the others never join. Collective-free consumers (fleet-sharded streaming
    inference) pass False to cover every sample.
    """

    def __init__(self, dataset, process_id: int | None = None,
                 num_processes: int | None = None, drop_ragged_tail: bool = True):
        if process_id is None:
            process_id = process_index()
        if num_processes is None:
            num_processes = process_count()
        if not 0 <= process_id < num_processes:
            raise ValueError(f"process_id {process_id} must be in [0, {num_processes})")
        self._dataset = dataset
        n = len(dataset)
        if drop_ragged_tail:
            n = n // num_processes * num_processes
        self._indices = local_shard_indices(n, process_id, num_processes)

    def __len__(self):
        return len(self._indices)

    def __getitem__(self, idx):
        return self._dataset[self._indices[idx]]

    def __getattr__(self, name):  # passthrough (e.g. .samples metadata)
        return getattr(self._dataset, name)

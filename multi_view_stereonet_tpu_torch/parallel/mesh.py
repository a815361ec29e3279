"""The ``(data, view)`` process grid, and the reductions that make a step's losses and
gradients those of the global batch.

Port of ``multi_view_stereonet_tpu/parallel/mesh.py`` and ``make_global_mesh``
(``parallel/distributed.py``). The JAX step runs under ``jit`` on global arrays, so
every reduction in it is over the global batch, and XLA inserts the collectives. The
port's processes each hold a shard, and the collectives are explicit:

- rank ``r`` is data shard ``r // view`` and view shard ``r % view``: a view group
  is ``view`` consecutive ranks on one host (the JAX rule that ``view`` divides the
  per-process device count). The group's first rank loads its samples and hands
  each rank its ``V / view`` comparison views (:class:`ViewGroupFeed`), as one JAX
  process loads a batch and shards its views over its devices; ``local_views``
  shards the poses, which the unpack first scales by the first view's baseline, as
  the JAX unpack of the global batch does.
- Inside ``reducing_over(mesh)`` (the train step's forward), :func:`batch_sums` all-reduces
  the losses' numerators and counts over the data group, so that each masked mean
  is over the global batch, its empty-mask rule decided on the global count; and
  :func:`view_mean` turns the forward's means over V into sums all-reduced over the
  view group, divided by the global V.
- Those all-reduces are differentiable, their backward an all-reduce of the
  gradient. Every rank then computes the same global loss L, and its gradient is
  that of the sum of all ranks' copies of L through its own share of the work: the
  mean over all ranks (:meth:`ProcessMesh.average_gradients`) is dL/dtheta, for the
  data axis, the view axis and the parameters each rank of a view group computes in
  duplicate alike.

Outside ``reducing_over``, and for a single process, nothing is reduced and no
collective is launched: the single-process code paths are unchanged. Nor does
:class:`ViewGroupFeed` launch one where ``view`` is 1.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses

import torch
import torch.distributed as dist

from .distributed import local_process_count, process_count, process_index

# The view-axis entries that a rank loads only its share of (JAX ``_VIEW_KEYS`` less the
# poses, which ``local_views`` shards after the unpack has read the first view's).
_SHARDED_KEYS = ("right_images", "right_depthmap_true")
_active: contextvars.ContextVar = contextvars.ContextVar("active_mesh", default=None)


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group's ranks; the backward sums the gradient the same way (the
    adjoint of y_s = sum_r x_r on every rank s)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


@dataclasses.dataclass(frozen=True)
class ProcessMesh:
    """This rank's place in a ``data`` x ``view`` grid of processes and its groups
    (None where the group has one rank: nothing to reduce). ``reducing_over(mesh)``
    makes the losses and the forward reduce over it; see the module docstring."""

    data: int = 1
    view: int = 1
    data_index: int = 0
    view_index: int = 0
    data_group: object = None
    view_group: object = None
    control_group: object = None  # a gloo group over every rank, for host flags

    @property
    def distributed(self) -> bool:
        return self.control_group is not None

    def local_batch_size(self, batch_size: int) -> int:
        """The samples each data shard loads of a global ``batch_size``."""
        if batch_size % self.data:
            raise ValueError(f"batch_size {batch_size} must be divisible by the mesh's "
                             f"data size {self.data} ({self.data * self.view} processes, "
                             f"mesh_view {self.view})")
        return batch_size // self.data

    def views(self, x, index: int | None = None):
        """The ``V / view`` comparison views of ``x`` (B, V, ...) of view shard ``index``
        (this rank's where it is None)."""
        if self.view == 1:
            return x
        V = x.shape[1]
        if V % self.view:
            raise ValueError(f"{V} comparison views are not divisible by mesh_view "
                             f"{self.view}")
        n = V // self.view
        index = self.view_index if index is None else index
        return x[:, index * n:(index + 1) * n]

    def shard_batch(self, batch: dict) -> dict:
        """The batch with this rank's comparison views of its images and depthmaps.
        The poses stay whole: the unpack scales every view by the first view's
        baseline, then keeps this rank's (``local_views``)."""
        return {k: self.views(v) if k in _SHARDED_KEYS else v for k, v in batch.items()}

    def average_gradients(self, params):
        """Replace each ``.grad`` by its mean over every rank, in one flat all-reduce.
        Parameters without a gradient are left out; every rank runs the same graph,
        so they are the same ones everywhere."""
        if not self.distributed:
            return
        grads = [p.grad for p in params if p.grad is not None]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        flat /= dist.get_world_size()
        for g, chunk in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(chunk.view_as(g))

    def any(self, flag: bool) -> bool:
        """True on every rank if ``flag`` is True on any (a host-side collective)."""
        if not self.distributed:
            return flag
        t = torch.tensor([int(flag)])
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.control_group)
        return bool(t.item())


def make_process_mesh(view: int = 1) -> ProcessMesh:
    """The ``(data, view)`` grid over every process of the group; with no group, one
    process holding the whole batch. ``view`` must divide the processes on each host,
    so that a view group never crosses hosts."""
    if not dist.is_initialized():
        if view != 1:
            raise ValueError(f"mesh_view {view} shards the comparison views over {view} "
                             "processes; this run has one")
        return ProcessMesh()
    world, rank = process_count(), process_index()
    if view < 1 or local_process_count() % view:
        raise ValueError(f"mesh_view {view} must divide the processes on each host "
                         f"({local_process_count()}), so that view groups stay on a host")
    data = world // view
    # Every rank creates every group, in the same order.
    view_groups = ([dist.new_group(list(range(d * view, (d + 1) * view)))
                    for d in range(data)] if view > 1 else None)
    if data == 1:
        data_groups = None
    elif view == 1:
        data_groups = [dist.group.WORLD]
    else:
        data_groups = [dist.new_group(list(range(v, world, view))) for v in range(view)]
    control = (dist.group.WORLD if dist.get_backend() == "gloo"
               else dist.new_group(backend="gloo"))
    d, v = divmod(rank, view)
    return ProcessMesh(data=data, view=view, data_index=d, view_index=v,
                       data_group=None if data_groups is None else data_groups[v],
                       view_group=None if view_groups is None else view_groups[d],
                       control_group=control)


class ViewGroupFeed:
    """The batches of one loader a view group, each rank's share on its device.

    Iterating yields ``(batch, tensors)``: ``tensors`` the share this rank trains on,
    on ``device``, filenames left out; ``batch`` the loader's batch itself (every view,
    filenames in) on the rank that loaded it, None on the others.

    With ``mesh.view`` 1 every rank iterates its own ``loader`` and nothing crosses.
    Otherwise the group's leader (``view_index`` 0) alone iterates it, decoding and
    augmenting each batch once with all its threads, as the JAX CLI's one process
    loads a batch for all its devices. What crosses, from the leader to each rank of
    its group: the keys every rank needs whole (the left image, ``K``,
    ``T_right_in_left``, the left depthmap where the split has one), broadcast; and
    that rank's ``V / view`` slice of ``right_images`` and ``right_depthmap_true``,
    scattered; the images at the loader's dtype (uint8 under ``transfer_u8``). Why:
    each rank loading the same samples itself would pair them with other augmentation
    draws at more than one loader thread (``data/transforms.py`` ``ThreadLocalRng``),
    and would decode every batch once a rank on the same host. Over NCCL (a card a
    process) the leader copies the batch to its card and sends card to card, so the
    other ranks make no host-to-device copy; over gloo (a card shared, or the CPU)
    host tensors cross. The other ranks decode nothing and take ``len(loader)``
    batches, which the dataset's length gives, so every rank takes the same steps;
    the first batch of each pass also sends the keys' names, shapes and dtypes."""

    def __init__(self, mesh: ProcessMesh, loader, device):
        self.mesh, self.loader, self.device = mesh, loader, torch.device(device)

    def __len__(self):
        return len(self.loader)

    def set_epoch(self, epoch: int):
        self.loader.set_epoch(epoch)

    def __iter__(self):
        from ..eval.streaming import to_device  # eval/ imports this package

        mesh = self.mesh
        if mesh.view_group is None:
            for batch in self.loader:
                yield batch, to_device(_arrays(batch), self.device)
            return
        group, leader = mesh.view_group, mesh.data_index * mesh.view
        on_card = dist.get_backend(group) == "nccl"
        spec = [None]  # [(key, shape, dtype)], sent with the first batch
        if mesh.view_index == 0:
            for batch in self.loader:
                whole = {k: torch.as_tensor(v) for k, v in _arrays(batch).items()}
                if on_card:
                    whole = to_device(whole, self.device)
                if spec[0] is None:
                    spec[0] = [(k, tuple(t.shape), t.dtype) for k, t in whole.items()]
                    dist.broadcast_object_list(spec, src=leader, group=group)
                mine = {}
                for k, t in whole.items():
                    if k in _SHARDED_KEYS:
                        parts = [mesh.views(t, i).contiguous() for i in range(mesh.view)]
                        mine[k] = torch.empty_like(parts[0])
                        dist.scatter(mine[k], parts, src=leader, group=group)
                    else:
                        dist.broadcast(t, src=leader, group=group)
                        mine[k] = t
                yield batch, mine if on_card else to_device(mine, self.device)
            return
        carrier = self.device if on_card else torch.device("cpu")
        for _ in range(len(self.loader)):
            if spec[0] is None:
                dist.broadcast_object_list(spec, src=leader, group=group)
            mine = {}
            for k, shape, dtype in spec[0]:
                if k in _SHARDED_KEYS:
                    shape = (shape[0], shape[1] // mesh.view, *shape[2:])
                mine[k] = torch.empty(shape, dtype=dtype, device=carrier)
                if k in _SHARDED_KEYS:
                    dist.scatter(mine[k], src=leader, group=group)
                else:
                    dist.broadcast(mine[k], src=leader, group=group)
            yield None, mine if on_card else to_device(mine, self.device)


def _arrays(batch: dict) -> dict:
    """A loader batch's arrays: every key but the filenames."""
    return {k: v for k, v in batch.items() if not k.endswith("filenames")}


@contextlib.contextmanager
def reducing_over(mesh: ProcessMesh | None):
    """Within it, :func:`batch_sums`, :func:`batch_mean` and :func:`view_mean` reduce
    over ``mesh``'s groups (the forward of a step; a backward needs no context)."""
    token = _active.set(mesh)
    try:
        yield mesh
    finally:
        _active.reset(token)


def batch_sums(*tensors: torch.Tensor) -> tuple:
    """The tensors summed over the active mesh's data group, in one collective with a
    gradient; as they are outside ``reducing_over`` or where the data axis is 1."""
    mesh = _active.get()
    if mesh is None or mesh.data_group is None:
        return tensors
    return tuple(_AllReduceSum.apply(torch.stack(tensors), mesh.data_group).unbind())


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of every element of ``x`` (batch-leading) over the global batch."""
    mesh = _active.get()
    if mesh is None or mesh.data_group is None:
        return x.mean()
    total, count = batch_sums(x.sum(), x.new_tensor(float(x.numel())))
    return total / count


def local_views(x: torch.Tensor) -> torch.Tensor:
    """This rank's comparison views of ``x`` (B, V, ...) under the active mesh's view
    group; ``x`` itself otherwise."""
    mesh = _active.get()
    if mesh is None or mesh.view_group is None:
        return x
    return mesh.views(x)


def view_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over the comparison-view axis (dim 1) of ``x``, over every view of the
    active mesh's view group: the sum over this rank's views all-reduced, with a
    gradient, over the global V."""
    mesh = _active.get()
    if mesh is None or mesh.view_group is None:
        return x.mean(dim=1)
    return _AllReduceSum.apply(x.sum(dim=1), mesh.view_group) / (x.shape[1] * mesh.view)

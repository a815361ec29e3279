"""The ``(data, view)`` process grid, and the reductions that make a step's losses and
gradients those of the global batch.

Port of ``multi_view_stereonet_tpu/parallel/mesh.py`` and ``make_global_mesh``
(``parallel/distributed.py``). The JAX step runs under ``jit`` on global arrays, so
every reduction in it is over the global batch, and XLA inserts the collectives. The
port's processes each hold a shard, and the collectives are explicit:

- rank ``r`` is data shard ``r // view`` and view shard ``r % view``: a view group
  is ``view`` consecutive ranks on one host (the JAX rule that ``view`` divides the
  per-process device count). Every rank of a view group loads the same samples and
  keeps its ``V / view`` comparison views (``shard_batch``, and ``local_views`` for
  the poses, which the unpack first scales by the first view's baseline, as the JAX
  unpack of the global batch does).
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
collective is launched: the single-process code paths are unchanged.
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

    def views(self, x):
        """This rank's ``V / view`` comparison views of ``x`` (B, V, ...)."""
        if self.view == 1:
            return x
        V = x.shape[1]
        if V % self.view:
            raise ValueError(f"{V} comparison views are not divisible by mesh_view "
                             f"{self.view}")
        n = V // self.view
        return x[:, self.view_index * n:(self.view_index + 1) * n]

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

"""The training step: the loss, its backward and an update as optax computes it.

Port of ``multi_view_stereonet_tpu/train/step.py``: the multi-view recipe (the
reference's params.yaml: adam, learning_rate 1e-3, scheduler_gamma 1.0) and the
two-view one (``multi_view=False``, ``estimate_right_idepthmap``: a second forward with
the roles of the images swapped feeds the right view's losses).
The JAX package composes optax; the port holds each piece to what optax 0.2.6
computes, not to torch's defaults:

- adam: ``torch.optim.Adam`` (b1 0.9, b2 0.999, eps 1e-8 outside the root), as
  ``optax.adam``;
- sgd: ``torch.optim.SGD`` without momentum, as ``optax.sgd``;
- rmsprop: ``RMSprop`` below, as ``optax.rmsprop``: decay 0.9 from a zero second
  moment, eps 1e-8 inside the root (``torch.optim.RMSprop`` takes alpha 0.99 and eps
  outside);
- ``scheduler_gamma`` != 1: a staircase decay by gamma every ``steps_per_epoch``
  applied updates (``optax.exponential_decay(staircase=True)``);
- ``batches_per_step`` k > 1 (``optax.MultiSteps``): the gradients' running mean over
  k batches, one update on every k-th. The schedule counts applied updates only, so
  with k = 2 the rate decays every two epochs' worth of batches, as in the JAX CLI.

The forward runs at the config's ``matmul_precision`` stage by stage, its convs'
gradients too; the losses, the rest of the backward and the update run exact
(``ops.precision.scope("ieee")``), as the JAX step scopes only the forward.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..losses import LossConfig, compute_losses
from ..models import MultiViewStereoNetConfig, mvsnet_forward
from ..ops.precision import scope
from ..ops.quantize import dequantize_images_u8, dequantize_images_u8_unit
from ..parallel.mesh import ProcessMesh, reducing_over
from .pipeline import multi_view_unpack_batch, unpack_batch

IMAGE_KEYS = ("left_image", "right_images")  # the multi-view batch's; two-view: right_image
OPTIMIZERS = ("adam", "rmsprop", "sgd")


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    optimizer: str = "adam"
    learning_rate: float = 1e-3
    scheduler_gamma: float = 1.0
    steps_per_epoch: int = 1
    batches_per_step: int = 1


class RMSprop(torch.optim.Optimizer):
    """``optax.rmsprop(lr)``: nu = decay nu + (1 - decay) g^2 from nu = 0, then
    p -= lr g / sqrt(nu + eps)."""

    def __init__(self, params, lr: float, decay: float = 0.9, eps: float = 1e-8):
        super().__init__(params, {"lr": lr, "decay": decay, "eps": eps})

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                nu = self.state[p].setdefault("nu", torch.zeros_like(p))
                nu.mul_(group["decay"]).addcmul_(p.grad, p.grad, value=1 - group["decay"])
                p.addcdiv_(p.grad, (nu + group["eps"]).sqrt(), value=-group["lr"])


class ScheduledOptimizer:
    """One of ``OPTIMIZERS`` with optax's learning-rate schedule and gradient
    accumulation around it (see the module docstring). ``step`` reads each parameter's
    ``.grad``."""

    def __init__(self, params, config: OptimizerConfig):
        self.params = list(params)
        self.config = config
        lr = config.learning_rate
        if config.optimizer == "adam":
            self.inner = torch.optim.Adam(self.params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
        elif config.optimizer == "sgd":
            self.inner = torch.optim.SGD(self.params, lr=lr)
        elif config.optimizer == "rmsprop":
            self.inner = RMSprop(self.params, lr=lr)
        else:
            raise ValueError(f"unknown optimizer {config.optimizer!r}: one of {OPTIMIZERS}")
        self.updates = 0     # updates applied, the schedule's count
        self.mini_step = 0   # batches accumulated towards the next update
        self.accumulated = None

    def learning_rate(self) -> float:
        """The rate of the next update."""
        c = self.config
        if c.scheduler_gamma == 1.0:
            return c.learning_rate
        return c.learning_rate * c.scheduler_gamma ** (self.updates // c.steps_per_epoch)

    def zero_grad(self):
        self.inner.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> bool:
        """Apply the gradients, or with ``batches_per_step`` k > 1 fold them into the
        running mean and apply that on every k-th call. Returns whether the weights
        changed."""
        k = self.config.batches_per_step
        if k > 1:
            if self.accumulated is None:
                self.accumulated = [torch.zeros_like(p) for p in self.params]
            for p, acc in zip(self.params, self.accumulated):
                if p.grad is not None:
                    acc.add_((p.grad - acc) / (self.mini_step + 1))
                else:
                    acc.sub_(acc / (self.mini_step + 1))
            self.mini_step = (self.mini_step + 1) % k
            if self.mini_step:
                return False
            for p, acc in zip(self.params, self.accumulated):
                p.grad = acc.clone()
                acc.zero_()
        for group in self.inner.param_groups:
            group["lr"] = self.learning_rate()
        self.inner.step()
        self.updates += 1
        return True

    def state_dict(self) -> dict:
        return {"inner": self.inner.state_dict(), "updates": self.updates,
                "mini_step": self.mini_step, "accumulated": self.accumulated}

    def load_state_dict(self, state: dict):
        self.inner.load_state_dict(state["inner"])
        self.updates, self.mini_step = state["updates"], state["mini_step"]
        acc = state["accumulated"]
        self.accumulated = (None if acc is None else
                            [a.to(p.device) for a, p in zip(acc, self.params)])


def make_optimizer(config: OptimizerConfig, params) -> ScheduledOptimizer:
    return ScheduledOptimizer(params, config)


def dequantize_batch(batch: dict, transfer_u8: str | None) -> dict:
    """The batch with uint8 images dequantized on their device, bit-exactly: "unit" is
    x / 255 (the augmented recipe, which leaves out Normalize), "full" x / 255 * 2 - 1.
    The mode and the images' dtype must agree: a float image under a u8 mode, or a u8
    image without one, raises."""
    batch = dict(batch)
    for key in (*IMAGE_KEYS, "right_image"):
        if key not in batch:
            continue
        if (batch[key].dtype == torch.uint8) != bool(transfer_u8):
            raise TypeError(f"{key} is {batch[key].dtype} but transfer_u8 is {transfer_u8!r}")
        if transfer_u8 == "unit":
            batch[key] = dequantize_images_u8_unit(batch[key])
        elif transfer_u8 == "full":
            batch[key] = dequantize_images_u8(batch[key])
        elif transfer_u8:
            raise ValueError(f"transfer_u8 must be 'unit', 'full' or None, got {transfer_u8!r}")
    return batch


def make_loss_fn(model_config: MultiViewStereoNetConfig, loss_config: LossConfig,
                 multi_view: bool = True, estimate_right_idepthmap: bool = False,
                 transfer_u8: str | None = None, impl: str = "auto") -> Callable:
    """loss(model, batch) -> (loss, loss dict) over a batch dict of tensors on the
    model's device: ``multi_view_unpack_batch``'s keys, or with ``multi_view=False``
    ``unpack_batch``'s (one right_image, T_right_in_left (B, 4, 4)), truth depthmaps
    included. With ``estimate_right_idepthmap`` (the two-view recipe, reference
    multi_view_stereonet_utils.py:522-537; the JAX step ignores it on a multi-view
    batch, and so does this one) a second forward takes the right image as its left,
    the left pyramid as its one comparison view and T_left_in_right as its pose; its
    pyramids become the right_idepthmap outputs. ``transfer_u8`` ("unit" | "full" |
    None): the images arrive as raw uint8 and the float stages the host pipeline left
    out are applied on the device first. ``impl`` reaches every kernel, the losses'
    samples included: "plain" is plain all the way down."""

    def loss_fn(model, batch):
        batch = dequantize_batch(batch, transfer_u8)
        levels = model_config.num_levels
        if multi_view:
            inputs = multi_view_unpack_batch(batch, levels)
            T, right_pyrs = inputs["T_right_in_left"], inputs["right_image_pyr"]
        else:
            inputs = unpack_batch(batch, levels)
            T = inputs["T_right_in_left"][:, None]
            right_pyrs = [p[:, None] for p in inputs["right_image_pyr"]]
        outputs = mvsnet_forward(model, inputs["left_image_pyr"], inputs["K_pyr"], T,
                                 right_pyrs, model_config, impl)
        if estimate_right_idepthmap and not multi_view:
            right_out = mvsnet_forward(
                model, inputs["right_image_pyr"], inputs["K_pyr"],
                inputs["T_left_in_right"][:, None],
                [p[:, None] for p in inputs["left_image_pyr"]], model_config, impl)
            outputs = dict(outputs)
            for kind in ("", "_raw", "_mask"):
                outputs[f"right_idepthmap{kind}_pyr"] = right_out[f"left_idepthmap{kind}_pyr"]
        with scope("ieee"):  # the losses' blurs exact, their gradients too
            loss, loss_dict, _ = compute_losses(inputs, outputs, loss_config, impl)
        return loss, loss_dict

    return loss_fn


def make_train_step(model_config: MultiViewStereoNetConfig, loss_config: LossConfig,
                    optimizer: ScheduledOptimizer, multi_view: bool = True,
                    estimate_right_idepthmap: bool = False, transfer_u8: str | None = None,
                    impl: str = "auto", mesh: ProcessMesh | None = None) -> Callable:
    """step(model, batch) -> (loss, loss dict): the loss, its backward and one
    ``optimizer.step()``, queued on the device; the loss stays there.

    With a multi-process ``mesh`` the batch is this rank's shard (``mesh.shard_batch``
    of its data shard's samples): the forward reduces over the mesh, so the loss and
    loss dict are the global batch's on every rank, and the gradients are averaged
    over the ranks before the update, which makes them the global batch's (see
    ``parallel/mesh.py``). With ``batches_per_step`` k > 1 each mini-step's gradients
    are averaged, and their running mean is that of the averages."""
    loss_fn = make_loss_fn(model_config, loss_config, multi_view, estimate_right_idepthmap,
                           transfer_u8, impl)

    def train_step(model, batch):
        optimizer.zero_grad()
        with scope("ieee"):  # exact outside the forward's stages, whatever the caller's flags
            if mesh is None:
                loss, loss_dict = loss_fn(model, batch)
            else:
                with reducing_over(mesh):
                    loss, loss_dict = loss_fn(model, batch)
            loss.backward()
            if mesh is not None:
                mesh.average_gradients(optimizer.params)
            optimizer.step()
        return loss.detach(), {k: [x.detach() for x in v] if isinstance(v, list)
                               else v.detach() for k, v in loss_dict.items()}

    return train_step

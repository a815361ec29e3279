"""Training CLI: the reference recipe on CUDA cards (or the CPU, when asked).

Port of ``multi_view_stereonet_tpu/train/train_cli.py``: multi-view supervised
training, or the two-view recipe (``estimate_right_idepthmap``, with the
reconstruction and left-right losses when their factors are set), with per-epoch
validation (EPE and outlier rates, validation.txt), per-epoch checkpoints
(``checkpoints/epochNNNN``) and resume from the latest, loss logs and plots, debug
images, and a SIGTERM-safe stop.

Several processes train as one (``--coordinator host:port --num_processes N
--process_id i``, or the ``MVS_COORDINATOR_ADDRESS`` / ``MVS_NUM_PROCESSES`` /
``MVS_PROCESS_ID`` environment variables), one process per card, as the JAX CLI's
processes train on one global mesh (``parallel/``). ``batch_size`` stays the global
batch: each data shard loads ``batch_size / data`` samples of its strided shard of the
split, and with ``mesh_view`` v > 1 the first process of each group of v loads those
samples and hands each process of the group its share of their comparison views
(``parallel.ViewGroupFeed``), at any ``num_workers``. Every rank holds the global batch's loss, which
the delayed finiteness check reads on every rank, and the global gradient. Process 0
alone writes losses.txt, plots, debug images, validation and checkpoints (the bare
module's ``state_dict``, as a single process writes them); validation and debug
images run there without the mesh, over every view.

The host never waits on the card for a step (but at each gloo all-reduce of a CUDA
tensor, which goes through the host): the loss stays on the device, and each step's
loss and loss dict are read (checked finite, logged) only after the next step is
queued. A non-finite loss dumps the last train state whose loss was checked
finite as ``checkpoints/epochNNNN-nanabort`` and exits with code 3.

Usage:
  python -m multi_view_stereonet_tpu_torch.train.train_cli \\
      --config params.yaml --data_dir <dir> --train_split <file> \\
      [--val_split <file>] --output_dir <run_dir> [--max_steps N] [--device cpu] \\
      [--coordinator host:port --num_processes N --process_id i]

With several processes, start one per card with the same arguments and its own
``--process_id``; the backend is NCCL where each has a card of its own, gloo where
they share one or run on the CPU.

``compute_dtype: bfloat16`` in params.yaml trains with bf16 activations, as the JAX
CLI does: each layer casts its f32 weights to its input's dtype, and the parameters,
the optimizer's state, the loss and the gradients stay f32. The CLI reads
``compute_dtype`` alone of the dtype keys, as the JAX CLI does; the refiner and
frontend dtypes follow it. ``matmul_precision: high`` trains with the forward's convs
and their gradients at TF32 (cuDNN's TF32, K2 and K3 1xTF32), the losses and the
optimizer exact; "default" (the default) and "highest" are exact f32. The precision
comes from the config: the forward and the step set the TF32 flags themselves and
restore the caller's, so ``train`` computes the same whatever flags its caller set.
``main`` also keeps them off (``torch.backends.cudnn.allow_tf32`` and
``torch.backends.cuda.matmul.allow_tf32`` False).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import math
import os
import signal
import sys
import threading
import time

import numpy as np
import torch

from ..checkpoint import init_params_numpy, state_dict_from_jax_params
from ..checkpoint import native as ckpt
from ..data import (
    BatchLoader, DeMoNDataset, GTASfMMultiViewDataset, get_testing_transforms,
    get_training_transforms, training_u8_dequantize_mode)
from ..eval.streaming import model_config_from_params as eval_model_config
from ..eval.streaming import serving_device, to_device
from ..losses import LossConfig, compute_losses
from ..models import (
    MultiViewStereoNet, MultiViewStereoNetConfig, mvsnet_forward, resolve_dtypes)
from ..ops.quantize import dequantize_images_u8
from ..parallel import (
    ShardedDataset, ViewGroupFeed, initialize, is_main_process, make_process_mesh,
    shutdown)
from ..utils.timing import count_parameters, profile_trace, set_seeds
from .config import load_params_yaml
from .logging import log_debug_images, log_losses, log_validation_metrics, plot_losses
from .pipeline import multi_view_unpack_batch
from .step import (
    IMAGE_KEYS, OptimizerConfig, dequantize_batch, make_optimizer, make_train_step)
from .validation import disparity_metrics


def make_dataset(params, data_dir, split_file, training, num_images=0, rng=None):
    """The training (augmented when ``augment``) or validation dataset of a split; with
    ``transfer_u8`` its images stay uint8 and are dequantized on the device."""
    u8 = params.get("transfer_u8", False)
    transform = (get_training_transforms(params, rng, u8_output=u8) if training
                 else get_testing_transforms(params, u8_output=u8))
    backend = params.get("decode_backend", "auto")
    if "gta_sfm" in (params.get("split", "") + split_file):
        return GTASfMMultiViewDataset(data_dir, split_file, num_images, transform,
                                      load_groundtruth_depthmaps=True, seed=params["seed"],
                                      decode_backend=backend)
    return DeMoNDataset(data_dir, split_file, num_right_images=1, num_left_images=num_images,
                        transform=transform, seed=params["seed"], decode_backend=backend)


def model_config_from_params(params_cfg) -> MultiViewStereoNetConfig:
    """The forward's knobs from a loaded params.yaml as the JAX train CLI reads them
    (``multi_view_stereonet_tpu/train/train_cli.py:92-100``): the shapes,
    ``compute_dtype`` (the refiner and frontend dtypes follow it),
    ``matmul_precision`` and ``remat_refiners``. A dtype or precision name that
    ``resolve_dtypes`` or ``resolve_precision`` does not know raises."""
    config = dataclasses.replace(eval_model_config(params_cfg),
                                 remat_refiners=params_cfg.get("remat_refiners", False))
    resolve_dtypes(config)
    return config


def build_train_step(params_cfg, steps_per_epoch, model, impl="auto", mesh=None):
    """(model config, loss config, optimizer over ``model``'s parameters, train step);
    the step reduces over ``mesh`` (``parallel/mesh.py``) when one is given."""
    model_config = model_config_from_params(params_cfg)
    loss_config = LossConfig(
        supervision_factor=params_cfg["supervision_factor"],
        reconstruction_factor=params_cfg["reconstruction_factor"],
        left_right_factor=params_cfg["left_right_factor"])
    optimizer = make_optimizer(OptimizerConfig(
        optimizer=params_cfg["optimizer"],
        learning_rate=params_cfg["learning_rate"],
        scheduler_gamma=params_cfg["scheduler_gamma"],
        steps_per_epoch=steps_per_epoch,
        batches_per_step=params_cfg["batches_per_step"]), model.parameters())
    two_view = bool(params_cfg.get("estimate_right_idepthmap", False))
    u8_mode = (training_u8_dequantize_mode(params_cfg)
               if params_cfg.get("transfer_u8", False) else None)
    step = make_train_step(model_config, loss_config, optimizer, multi_view=not two_view,
                           estimate_right_idepthmap=two_view, transfer_u8=u8_mode, impl=impl,
                           mesh=mesh)
    return model_config, loss_config, optimizer, step


def two_view_batch(batch: dict) -> dict:
    """The loader's V-axis batch as the two-view step takes it: its first comparison
    view as right_image, with that view's depthmap and pose."""
    batch = dict(batch)
    batch["right_image"] = batch.pop("right_images")[:, 0]
    if "right_depthmap_true" in batch:
        batch["right_depthmap_true"] = batch["right_depthmap_true"][:, 0]
    batch["T_right_in_left"] = batch["T_right_in_left"][:, 0]
    return batch


def _dequantize_by_dtype(batch):
    """uint8 images (the testing pipeline's u8 output, Normalize included) dequantized
    with x / 255 * 2 - 1; float32 images as they are."""
    return {k: dequantize_images_u8(v) if k in IMAGE_KEYS and v.dtype == torch.uint8 else v
            for k, v in batch.items()}


def make_val_step(model_config, loss_config, impl="auto"):
    """val_step(model, batch) -> (loss, metrics): scalar tensors on the batch's device.
    ``refined_zero_frac`` is the share of the finest refined idepth at exactly 0: the
    refiners end in ReLU(idepth + delta), and a loss that drives delta below -idepth
    everywhere kills the output with no gradient to recover."""

    def val_step(model, batch):
        with torch.inference_mode():
            inputs = multi_view_unpack_batch(_dequantize_by_dtype(batch),
                                             model_config.num_levels)
            outputs = mvsnet_forward(model, inputs["left_image_pyr"], inputs["K_pyr"],
                                     inputs["T_right_in_left"], inputs["right_image_pyr"],
                                     model_config, impl)
            loss, _, _ = compute_losses(inputs, outputs, loss_config, impl)
            metrics = disparity_metrics(inputs["K_pyr"][0], inputs["T_right_in_left"][:, 0],
                                        outputs["left_idepthmap_pyr"][0],
                                        inputs["left_idepthmap_true"])
            metrics["refined_zero_frac"] = (outputs["left_idepthmap_pyr"][0] == 0).float().mean()
        return loss, metrics

    return val_step


def _batch_tensors(batch, device):
    return to_device({k: v for k, v in batch.items() if not k.endswith("filenames")}, device)


def validate(model, val_loader, val_step, device):
    """Mean loss and metrics over the validation batches, read back once at the end.
    The metric keys are sorted, as the JAX ``jit`` returns them (validation.txt's
    columns)."""
    sums, n, keys = None, 0, None
    for batch in val_loader:
        loss, metrics = val_step(model, _batch_tensors(batch, device))
        keys = sorted(metrics)
        row = torch.stack([loss.float()] + [metrics[k].float() for k in keys])
        sums = row if sums is None else sums + row
        n += 1
    if n == 0:
        return 0.0, {}
    means = (sums / n).cpu().numpy()
    return float(means[0]), {k: float(v) for k, v in zip(keys, means[1:])}


class GracefulStop:
    """SIGTERM -> finish the current step, checkpoint, exit cleanly.

    Batch schedulers send SIGTERM with a grace window before they kill a job. The
    handler only sets a flag: the train loop checks it between steps, writes a
    checkpoint labelled with the current epoch and stops, so a relaunch resumes from
    it (at the next epoch, with the step count kept)."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._event = threading.Event()
        self._previous = {}
        for s in signals:
            try:
                self._previous[s] = signal.signal(s, self._handle)
            except ValueError:  # not the main thread: flag-only mode
                pass

    def _handle(self, signum, frame):
        self._event.set()

    def __call__(self) -> bool:
        return self._event.is_set()

    def restore(self):
        for s, h in self._previous.items():
            signal.signal(s, h)


def _clone(tree):
    """A copy of a nest of dicts and lists whose tensors are cloned on their devices."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return tree


def _losses_to_host(loss, loss_dict):
    """(loss, loss dict) as floats, in one device-to-host copy, the dict's keys sorted as
    the JAX ``jit`` returns them (losses.txt's columns)."""
    loss_dict = {k: loss_dict[k] for k in sorted(loss_dict)}
    flat = [loss] + [x for v in loss_dict.values()
                     for x in (v if isinstance(v, (list, tuple)) else [v])]
    host = iter(torch.stack([torch.as_tensor(x, dtype=torch.float32, device=loss.device)
                             for x in flat]).cpu().tolist())
    lossf = next(host)
    return lossf, {k: [next(host) for _ in v] if isinstance(v, (list, tuple)) else next(host)
                   for k, v in loss_dict.items()}


def train(params_cfg, data_dir, train_split, val_split, output_dir, max_steps=0,
          max_epochs=None, profile_dir=None, profile_steps=4, stop_check=None, device=None,
          impl="auto"):
    """Train on ``device`` (the card unless it names another; with no card it raises)
    and return the model. Resumes from the latest epoch checkpoint under
    ``<output_dir>/checkpoints``, or starts from ``previous_checkpoint_dir``'s weights,
    or from the reference's init drawn from ``seed``. In a process group
    (``parallel.initialize``) every process calls it, and they train as one."""
    device = serving_device(device)
    model_config_from_params(params_cfg)  # an unknown dtype or precision name raises here
    if val_split and (params_cfg["reconstruction_factor"] > 0
                      or params_cfg["left_right_factor"] > 0):
        raise ValueError(
            "validation runs the multi-view forward, which has no right-view outputs, and "
            "reconstruction_factor or left_right_factor > 0 needs them (the JAX CLI fails "
            "there with a KeyError on 'left_occlusion_mask_pyr'): give no val_split, or "
            "set both factors to 0")
    two_view = bool(params_cfg.get("estimate_right_idepthmap", False))
    workers = params_cfg.get("num_workers", 4)
    mesh_view = int(params_cfg.get("mesh_view", 1))
    if mesh_view > 1 and two_view:
        raise ValueError("mesh_view > 1 shards the comparison views, and the two-view "
                         "recipe has one")
    mesh = make_process_mesh(view=mesh_view)
    is_main = is_main_process()
    log = print if is_main else (lambda *args, **kwargs: None)
    os.makedirs(output_dir, exist_ok=True)
    seed = params_cfg["seed"]
    set_seeds(seed)
    rng = np.random.default_rng(seed)
    batch_size = params_cfg["batch_size"]
    local_batch = mesh.local_batch_size(batch_size)

    dataset = make_dataset(params_cfg, data_dir, train_split, True,
                           params_cfg["num_train_images"], rng)
    if mesh.data > 1:
        dataset = ShardedDataset(dataset, mesh.data_index, mesh.data)
    # A view group's leader alone iterates it; the others take their shares from it.
    loader = BatchLoader(dataset, local_batch, shuffle=params_cfg["shuffle"], seed=seed,
                         workers=workers)
    feed = ViewGroupFeed(mesh, loader, device)
    steps_per_epoch = max(len(loader), 1)
    val_loader = None
    if val_split and is_main:
        val_dataset = make_dataset(params_cfg, data_dir, val_split, False,
                                   params_cfg["num_val_images"])
        val_loader = BatchLoader(val_dataset, batch_size, shuffle=False, drop_last=False,
                                 workers=workers)

    model = MultiViewStereoNet()
    model.load_state_dict(state_dict_from_jax_params(init_params_numpy(seed, reference=True)))
    model = model.to(device).train()
    model_config, loss_config, optimizer, train_step = build_train_step(
        params_cfg, steps_per_epoch, model, impl, mesh if mesh.distributed else None)
    val_step = make_val_step(model_config, loss_config, impl) if val_loader else None

    # Weights are loaded with load_state_dict, which writes each parameter in place
    # and bumps its version, so the refiner kernel repacks them; a write through
    # ``.data`` would need ops.cuda.refiner.invalidate_packed_weights().
    start_epoch, step_count = 0, 0
    ckpt_root = os.path.join(output_dir, "checkpoints")
    prev = params_cfg.get("previous_checkpoint_dir", "")
    latest = ckpt.latest_epoch(ckpt_root)
    # Every process loads the same state.
    if prev:
        model.load_state_dict(ckpt.load_params(prev))
        log(f"resumed params from {prev}")
    elif latest is not None:
        state = ckpt.load_train_state(ckpt_root, latest)
        model.load_state_dict(state["model"])
        optimizer.load_state_dict(state["optimizer"])
        start_epoch, step_count = latest + 1, state["step"]
        log(f"resumed from epoch {latest} (step {step_count})")

    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    log(f"model parameters: {count_parameters(model)}; training on {name}"
        + (f", {mesh.data} data x {mesh.view} view processes" if mesh.distributed else ""))
    # With workers > 1 the pairing of augmentation draws and samples depends on
    # thread scheduling (data/transforms.py ThreadLocalRng); a view group still trains
    # on one draw, its leader's.
    log(f"data loader workers: {workers} (run-to-run bit-reproducibility requires "
        "num_workers: 1)")
    u8_mode = (training_u8_dequantize_mode(params_cfg)
               if params_cfg.get("transfer_u8", False) else None)
    if u8_mode:
        log(f"image transport: uint8 (on-device dequantize mode '{u8_mode}'); numerics "
            "bit-identical to the f32 feed")

    loss_file = os.path.join(output_dir, "losses.txt")
    val_file = os.path.join(output_dir, "validation.txt")
    num_epochs = max_epochs if max_epochs is not None else params_cfg["num_epochs"]
    profiling = contextlib.ExitStack()
    if not is_main:
        profile_dir = None
    if profile_dir:
        profiling.enter_context(profile_trace(profile_dir))
    graceful = None
    if stop_check is None:
        graceful = stop_check = GracefulStop()

    def stop() -> bool:
        """Whether any process was asked to stop: all leave the loop together."""
        return mesh.any(stop_check())

    # ``good`` is the last (model, optimizer, step) state whose loss was checked finite;
    # ``pending`` the state that entered the step whose loss is queued but not read.
    # Process 0 alone keeps them: it alone dumps.
    good = pending = None

    def abort_if_nonfinite(lossf, epoch):
        """A non-finite loss dumps the last state checked finite (the live one has
        already taken the bad update) under a "-nanabort" tag, which resume never
        takes, and exits with code 3. The loss is the global batch's, so every process
        exits here at the same step; process 0 dumps."""
        if math.isfinite(lossf):
            return
        if is_main:
            dump = good or pending or (_clone(model.state_dict()),
                                       _clone(optimizer.state_dict()), step_count)
            path = ckpt.save_train_state(ckpt_root, epoch, *dump, suffix="-nanabort")
            print(f"FATAL: non-finite loss {lossf} at step {step_count}; last "
                  f"verified-good state (step {dump[2]}) dumped to {path}", file=sys.stderr,
                  flush=True)
        raise SystemExit(3)

    def finish(record):
        """Read a queued step's loss: check it, and log and plot on its print steps."""
        nonlocal good
        epoch, batch_idx, step, loss, loss_dict = record
        lossf, host_dict = _losses_to_host(loss, loss_dict)
        abort_if_nonfinite(lossf, epoch)
        good = pending
        if is_main and step % params_cfg["print_freq"] == 0:
            print(f"epoch {epoch} batch {batch_idx} step {step} loss {lossf:.4f}")
            log_losses(epoch, batch_idx, step, lossf, host_dict, loss_file)
        if is_main and params_cfg["plot_freq"] and step % params_cfg["plot_freq"] == 0:
            plot_losses(loss_file, os.path.join(output_dir, "plots"))

    try:
        for epoch in range(start_epoch, num_epochs):
            t_epoch = time.time()
            # The shuffle order is a function of the epoch, so a resumed run follows the
            # uninterrupted one.
            feed.set_epoch(epoch)
            queued = None
            for batch_idx, (batch, tensors) in enumerate(feed):
                entering = ((_clone(model.state_dict()), _clone(optimizer.state_dict()),
                             step_count) if is_main else None)
                loss, loss_dict = train_step(model, two_view_batch(tensors) if two_view
                                             else tensors)
                step_count += 1
                if queued is not None:
                    finish(queued)
                pending, queued = entering, (epoch, batch_idx, step_count, loss, loss_dict)
                if profile_dir and step_count >= profile_steps:
                    if device.type == "cuda":
                        torch.cuda.synchronize(device)
                    profiling.close()
                    profile_dir = None
                if (is_main and params_cfg["debug_image_freq"]
                        and step_count % params_cfg["debug_image_freq"] == 0):
                    # From the V-axis batch, every view, also in the two-view recipe;
                    # process 0 leads its view group, so it holds the loader's batch.
                    full = tensors if mesh.view == 1 else _batch_tensors(batch, device)
                    _debug_images(model, model_config, full, batch["left_filenames"],
                                  u8_mode, impl, epoch, step_count,
                                  os.path.join(output_dir, "debug_images"))
                if (max_steps and step_count >= max_steps) or stop():
                    break
            # The epoch's last step is read before its state is saved as a checkpoint.
            if queued is not None:
                finish(queued)

            stopping = stop()
            t_train = time.time() - t_epoch
            t_val = 0.0
            if val_loader is not None and not stopping:
                t0 = time.time()
                val_loss, metrics = validate(model, val_loader, val_step, device)
                t_val = time.time() - t0
                log_validation_metrics(epoch, val_loss, metrics, val_file)
                print(f"epoch {epoch} validation loss {val_loss:.4f} {metrics}")
                if metrics.get("refined_zero_frac", 0.0) >= 0.999:
                    print("WARNING: finest refined idepth output is all zero -- the "
                          "refiners' output ReLU has likely died (delta <= -idepth "
                          "everywhere; no recovery gradient). Check scene/idepth statistics "
                          "vs the hypothesis sweep range, or lower the learning rate.",
                          flush=True)
            if is_main:
                t0 = time.time()
                path = ckpt.save_train_state(ckpt_root, epoch, model,
                                             optimizer.state_dict(), step_count)
                tag = "preempted at" if stopping else "done in"
                print(f"epoch {epoch} {tag} {time.time() - t_epoch:.1f}s (train "
                      f"{t_train:.1f}s, val {t_val:.1f}s, ckpt {time.time() - t0:.1f}s); "
                      f"checkpoint: {path}")
            if stopping or (max_steps and step_count >= max_steps):
                break
    finally:
        profiling.close()
        if graceful is not None:
            graceful.restore()
    return model


def _debug_images(model, model_config, tensors, names, u8_mode, impl, epoch, step,
                  output_dir):
    """The first sample's idepth pyramid from the updated model, as debug images."""
    with torch.inference_mode():
        inputs = multi_view_unpack_batch(dequantize_batch(tensors, u8_mode),
                                         model_config.num_levels)
        outputs = mvsnet_forward(model, inputs["left_image_pyr"], inputs["K_pyr"],
                                 inputs["T_right_in_left"], inputs["right_image_pyr"],
                                 model_config, impl)
        host_inputs = {"left_filenames": names,
                       "left_image_pyr": [inputs["left_image_pyr"][0].cpu().numpy()]}
        if "left_idepthmap_true" in inputs:
            host_inputs["left_idepthmap_true"] = inputs["left_idepthmap_true"].cpu().numpy()
        host_outputs = {"left_idepthmap_pyr": [x.cpu().numpy()
                                               for x in outputs["left_idepthmap_pyr"]]}
    log_debug_images(epoch, step, 0, host_inputs, host_outputs, output_dir)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train MultiViewStereoNet (PyTorch).")
    parser.add_argument("--config", required=True, help="params.yaml")
    parser.add_argument("--data_dir", required=True)
    parser.add_argument("--train_split", required=True)
    parser.add_argument("--val_split", default="")
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--max_steps", type=int, default=0)
    parser.add_argument("--max_epochs", type=int, default=None)
    parser.add_argument("--profile_dir", default=None,
                        help="write a torch.profiler Chrome trace of the first steps here")
    parser.add_argument("--device", default="cuda",
                        help="'cpu' trains on the CPU (over gloo with several processes); "
                             "else each process takes a card of its own where it can")
    # Several processes, one per card. The defaults come from the
    # MVS_COORDINATOR_ADDRESS / MVS_NUM_PROCESSES / MVS_PROCESS_ID environment
    # variables; with neither, the run is one process.
    parser.add_argument("--coordinator", default=None,
                        help="host:port of process 0 for a multi-process run")
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    args = parser.parse_args(argv)
    if (args.num_processes is not None and args.process_id is not None
            and not 0 <= args.process_id < args.num_processes):
        parser.error(f"--process_id {args.process_id} must be in "
                     f"[0, --num_processes {args.num_processes})")

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    initialize(args.coordinator, args.num_processes, args.process_id, device=args.device)
    try:
        train(load_params_yaml(args.config), args.data_dir, args.train_split,
              args.val_split, args.output_dir, args.max_steps, args.max_epochs,
              profile_dir=args.profile_dir, device=args.device)
    finally:
        shutdown()


if __name__ == "__main__":
    main()

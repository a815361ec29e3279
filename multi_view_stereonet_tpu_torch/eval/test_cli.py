"""Evaluation CLI: run a checkpoint over a test split and write the metric files.

Port of ``multi_view_stereonet_tpu/eval/test_cli.py`` (reference test.py:188-409):
the same dataset dispatch (split-filename substring), depth masks (GTA
0-1000 m, DeMoN 0.5-10 m, "Limits from DPSNet"), output files (losses.txt,
depth_metrics.txt, runtime_metrics.txt, the avg_* files) and DeMoN
per-scene-type breakdown, with batches larger than 1. Runs on the card
unless the caller names another device.

Weights: ``<weights_dir>/stereo_network.pth`` (the port's state dict), or the JAX
package's ``stereo_network.msgpack``, or the reference's TorchScript
``stereo_network.pt``, the first found (``eval/streaming.py`` ``load_model``). Params:
``--params_yaml`` or ``<weights_dir>/../../params.yaml``.

Usage:
  python -m multi_view_stereonet_tpu_torch.eval.test_cli \\
      <weights_dir> <data_dir> <test_split> [--save_images] \\
      [--output_dir output] [--batch_size 1] [--device cpu]

``main`` runs in float32 with TF32 off (``torch.backends.cudnn.allow_tf32``
and ``torch.backends.cuda.matmul.allow_tf32`` False); a library caller of
``run_eval`` sets them as it needs.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..data import BatchLoader, DeMoNDataset, GTASfMMultiViewDataset, get_testing_transforms
from ..losses import LossConfig, compute_losses
from ..models import mvsnet_forward
from ..train.config import load_params_yaml
from ..train.logging import _flatten
from ..train.pipeline import multi_view_unpack_batch
from ..utils.timing import profile_trace
from ..utils.visualization import save_idepth_images
from .metrics import compute_avg_metrics, get_depth_prediction_metrics
from .streaming import (
    MODEL_KEYS, load_model, model_config_from_params, serving_device, to_device)

DEMON_TYPES = ("mvs", "sun3d", "rgbd", "scenes11")
EVAL_KEYS = MODEL_KEYS + ("left_depthmap_true",)


def load_data(data_dir, test_file, params, batch_size=1, roll_right_image_180=False,
              add_translation_noise=False, add_rotation_noise=False,
              decode_backend="auto"):
    """Dataset dispatch by split-filename substring (test.py:283-305), with the truth
    depthmaps loaded."""
    transforms = get_testing_transforms(
        params, roll_right_image_180, add_translation_noise, add_rotation_noise)
    if "gta_sfm" in test_file:
        dataset = GTASfMMultiViewDataset(
            data_dir, test_file, 0, transforms, load_groundtruth_depthmaps=True,
            decode_backend=decode_backend)
    elif "demon" in test_file:
        dataset = DeMoNDataset(data_dir, test_file, num_right_images=1,
                               num_left_images=0, transform=transforms,
                               decode_backend=decode_backend)
    else:
        raise ValueError(f"cannot infer dataset type from {test_file}")
    # Parallel decode only when the pipeline is deterministic: the pose and roll
    # perturbations draw from a shared generator, and thread order would change which
    # sample gets which draw.
    perturbed = roll_right_image_180 or add_translation_noise or add_rotation_noise
    return BatchLoader(dataset, batch_size, shuffle=False, drop_last=False,
                       workers=1 if perturbed else 4)


def depth_limits(split):
    if "gta_sfm" in split:
        return 0.0, 1e3
    return 0.5, 10.0  # Limits from DPSNet (test.py:175-185)


def _eval_step(model, batch, model_config, loss_config, impl):
    """Forward, losses and the metric idepthmap, queued on the batch's device."""
    inputs = multi_view_unpack_batch(batch, model_config.num_levels)
    outputs = mvsnet_forward(model, inputs["left_image_pyr"], inputs["K_pyr"],
                             inputs["T_right_in_left"], inputs["right_image_pyr"],
                             model_config, impl)
    loss, loss_dict, _ = compute_losses(inputs, outputs, loss_config, impl)
    idepth0 = outputs["left_idepthmap_pyr"][0] / inputs["baseline"][:, None, None]
    return loss, loss_dict, idepth0, inputs["baseline"]


def _to_host(loss, loss_dict, idepth0, baseline):
    """(loss, loss dict, idepth0, baseline) on the host, in one device-to-host copy:
    every scalar and both maps go into one flat tensor first (a read of each scalar
    alone would wait for the device once per scalar). The host loss dict's keys are
    sorted, as a dict comes back from a JAX jit, so losses.txt's columns are the JAX
    CLI's."""
    loss_dict = {k: loss_dict[k] for k in sorted(loss_dict)}
    values = [loss] + [vv for v in loss_dict.values()
                       for vv in (v if isinstance(v, (list, tuple)) else [v])]
    scalars = torch.stack([torch.as_tensor(v, dtype=torch.float32, device=idepth0.device)
                           for v in values])
    flat = torch.cat([scalars, idepth0.reshape(-1), baseline]).cpu().numpy()
    host = iter(flat[1:len(values)])
    host_dict = {k: [next(host) for _ in v] if isinstance(v, (list, tuple)) else next(host)
                 for k, v in loss_dict.items()}
    n = idepth0.numel()
    return (flat[0], host_dict, flat[len(values):len(values) + n].reshape(idepth0.shape),
            flat[len(values) + n:])


def _write_kv(path, d):
    with open(path, "w") as f:
        for k, v in d.items():
            f.write(f"{k}: {v}\n")


def _append_row(path, header, name, values):
    if not os.path.exists(path):
        with open(path, "w") as f:
            f.write(header + "\n")
    with open(path, "a") as f:
        f.write(name + " " + " ".join(str(v) for v in values) + "\n")


def run_eval(weights_dir, data_dir, test_split, output_dir="output", batch_size=1,
             save_images=False, params_file=None, roll_right_image_180=False,
             add_translation_noise=False, add_rotation_noise=False, decode_backend="auto",
             profile_dir=None, device="cuda", impl="auto"):
    """Evaluate the weights of ``weights_dir`` (``.pth``, ``.msgpack`` or ``.pt``, see
    ``load_model``) over a split on ``device``; write the metric files to ``output_dir``
    (which must not exist). Returns (mean loss over the batches, averaged depth
    metrics).

    ``runtime_ms`` of an image is the wall time of its batch's forward, losses and one
    copy of their results to the host, over the batch size. Each new batch shape (the
    trailing partial batch is one) is run once untimed first: the first call builds the
    kernels and lets cuDNN pick its algorithms."""
    if os.path.exists(output_dir):
        raise FileExistsError(f"{output_dir} already exists")
    device = serving_device(device)
    if params_file is None:
        params_file = os.path.join(weights_dir, "..", "..", "params.yaml")
    params_cfg = load_params_yaml(params_file)
    model_config = model_config_from_params(params_cfg)
    loss_config = LossConfig(
        supervision_factor=params_cfg["supervision_factor"],
        reconstruction_factor=params_cfg["reconstruction_factor"],
        left_right_factor=params_cfg["left_right_factor"])

    model = load_model(weights_dir, device)
    loader = load_data(data_dir, test_split, params_cfg, batch_size, roll_right_image_180,
                       add_translation_noise, add_rotation_noise,
                       decode_backend=decode_backend)
    os.makedirs(output_dir)

    min_depth, max_depth = depth_limits(test_split)
    total_loss, num_batches = 0.0, 0
    loss_file = os.path.join(output_dir, "losses.txt")
    depth_file = os.path.join(output_dir, "depth_metrics.txt")
    runtime_file = os.path.join(output_dir, "runtime_metrics.txt")

    def step(tensors):
        with torch.inference_mode():
            return _to_host(*_eval_step(model, tensors, model_config, loss_config, impl))

    warmed_shapes = set()
    with profile_trace(profile_dir):
        for batch in loader:
            names = batch["left_filenames"]
            tensors = to_device({k: batch[k] for k in EVAL_KEYS}, device)
            shape_key = tuple(sorted((k, tuple(v.shape)) for k, v in tensors.items()))
            if shape_key not in warmed_shapes:
                step(tensors)
                warmed_shapes.add(shape_key)
            t0 = time.perf_counter()
            loss, loss_dict, idepth0, _ = step(tensors)
            runtime_ms = (time.perf_counter() - t0) * 1000.0 / len(names)

            loss = float(loss)
            if not np.isfinite(loss):
                raise FloatingPointError("NaN loss during eval")
            total_loss += loss
            num_batches += 1
            lkeys, lvals = _flatten(loss_dict)

            for i, left_file in enumerate(names):
                # The loader's raw metric depth (the reference re-multiplies by the
                # baseline only because its unpack normalized it, test.py:166-186).
                depth_true = batch["left_depthmap_true"][i]
                idepth_est = idepth0[i]
                depth_est = np.where(idepth_est > 0, 1.0 / np.where(
                    idepth_est > 0, idepth_est, 1.0), idepth_est)

                # The reference protocol (test.py:221-235): skip an image only when its
                # truth mask is empty; the estimate's validity is intersected after,
                # so an image whose estimate is all out of range gives a (nan) row
                # instead of being dropped from the averages.
                mask = (depth_true > min_depth) & (depth_true < max_depth)
                if mask.sum() <= 0:
                    print(f"WARNING: No truth for image: {left_file}")
                    continue
                mask &= (depth_est > min_depth) & (depth_est < max_depth)

                if save_images:
                    idepth_true = np.where(depth_true > 0, 1.0 / np.where(
                        depth_true > 0, depth_true, 1.0), 0.0)
                    rel = os.path.relpath(left_file, data_dir)
                    img_dir = os.path.join(output_dir, os.path.dirname(rel))
                    os.makedirs(img_dir, exist_ok=True)
                    image_num = os.path.splitext(os.path.basename(rel))[0]
                    save_idepth_images(img_dir, image_num, idepth_est, idepth_true)

                _append_row(loss_file, "file loss " + " ".join(lkeys), left_file,
                            [loss] + lvals)
                m = get_depth_prediction_metrics(depth_true[mask], depth_est[mask])
                _append_row(depth_file, "file " + " ".join(m.keys()), left_file,
                            list(m.values()))
                _append_row(runtime_file, "file runtime_ms", left_file, [runtime_ms])
                print(f"image: {left_file}, LOSS: {loss:.2f}, "
                      f"ABS_REL: {m['abs_rel']:.2f}, A1: {m['a1']:.2f}")
            print(f"Processed batch {num_batches}/{len(loader)}")

    _write_kv(os.path.join(output_dir, "avg_losses.txt"), compute_avg_metrics(loss_file))
    avg_depth = compute_avg_metrics(depth_file)
    _write_kv(os.path.join(output_dir, "avg_depth_metrics.txt"), avg_depth)

    runtimes = np.loadtxt(runtime_file, skiprows=1, usecols=1, ndmin=1)
    _write_kv(os.path.join(output_dir, "avg_runtime_metrics.txt"),
              {"runtime_ms": float(np.mean(runtimes)), "num_samples": len(runtimes)})

    if "demon" in test_split:
        with open(depth_file, "r") as f:
            lines = f.readlines()
        header, rows = lines[0], lines[1:]
        for demon_type in DEMON_TYPES:
            selected = [ln for ln in rows if demon_type in ln]
            per_type = os.path.join(output_dir, f"depth_metrics_{demon_type}.txt")
            with open(per_type, "w") as f:
                f.write(header)
                f.writelines(selected)
            if selected:
                _write_kv(os.path.join(output_dir, f"avg_depth_metrics_{demon_type}.txt"),
                          compute_avg_metrics(per_type))

    return total_loss / max(num_batches, 1), avg_depth


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Run MultiViewStereoNet (PyTorch) inference over a split.")
    parser.add_argument("weights_dir", help="a directory holding stereo_network.pth, "
                        ".msgpack or .pt (the first found)")
    parser.add_argument("data_dir")
    parser.add_argument("test_split")
    parser.add_argument("--save_images", action="store_true")
    parser.add_argument("--output_dir", default="output")
    parser.add_argument("--batch_size", type=int, default=1)
    parser.add_argument("--params_yaml", default=None)
    # Robustness perturbations (reference test.py:285-290, off by default).
    parser.add_argument("--roll_right_image_180", action="store_true")
    parser.add_argument("--add_translation_noise", action="store_true")
    parser.add_argument("--add_rotation_noise", action="store_true")
    parser.add_argument("--decode_backend", default="auto",
                        choices=["auto", "native", "pil"],
                        help="image decode path; auto uses the native C++ loader when "
                             "available (bit-exact with PIL)")
    parser.add_argument("--profile_dir", default=None,
                        help="write a torch.profiler Chrome trace of the run here")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    loss, avg = run_eval(
        os.path.abspath(args.weights_dir), os.path.abspath(args.data_dir),
        os.path.abspath(args.test_split), args.output_dir, args.batch_size,
        args.save_images, args.params_yaml,
        roll_right_image_180=args.roll_right_image_180,
        add_translation_noise=args.add_translation_noise,
        add_rotation_noise=args.add_rotation_noise,
        decode_backend=args.decode_backend, profile_dir=args.profile_dir,
        device=args.device)
    print("avg loss:", loss)
    print("avg depth metrics:", avg)


if __name__ == "__main__":
    main()

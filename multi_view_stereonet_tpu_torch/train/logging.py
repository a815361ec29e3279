"""Training observability in the reference's formats: loss logs, plots, debug images.

Port of ``multi_view_stereonet_tpu/train/logging.py``:
- losses.txt: ``epoch batch step loss <key...>`` rows
  (reference multi_view_stereonet_utils.py:30-56);
- validation.txt: ``epoch loss <metric...>`` (reference :58-74);
- loss plots with summed-area-table smoothing (reference :76-158), matplotlib
  imported only when a plot is drawn;
- colormapped idepth debug images and HTML training galleries (reference
  :245-404), and occlusion masks as grayscale images (reference :272-289). Inputs
  are numpy arrays (or anything ``np.asarray`` takes); the masks also tensors on any
  device.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

from ..utils import image_gallery
from ..utils.visualization import apply_cmap


def _flatten(loss_dict):
    """(keys, float values) of a loss dict; a list value ``k`` becomes ``k0``, ``k1``..."""
    keys, values = [], []
    for k, v in loss_dict.items():
        if isinstance(v, (list, tuple)):
            for i, vv in enumerate(v):
                keys.append(f"{k}{i}")
                values.append(float(vv))
        else:
            keys.append(k)
            values.append(float(v))
    return keys, values


def log_losses(epoch, batch, step, loss, loss_dict, output_file):
    keys, values = _flatten(loss_dict)
    if not os.path.exists(output_file):
        with open(output_file, "w") as f:
            f.write("epoch batch step loss " + " ".join(keys) + " \n")
    with open(output_file, "a") as f:
        f.write(f"{epoch} {batch} {step} {float(loss)} "
                + " ".join(str(v) for v in values) + " \n")


def log_validation_metrics(epoch, loss, metrics, output_file):
    if not os.path.exists(output_file):
        with open(output_file, "w") as f:
            f.write("epoch loss " + " ".join(metrics.keys()) + " \n")
    with open(output_file, "a") as f:
        f.write(f"{epoch} {float(loss)} "
                + " ".join(str(float(v)) for v in metrics.values()) + " \n")


def _smooth(xaxis, series, max_samples=100):
    """Summed-area-table running mean and std (reference :110-133)."""
    factor = int(np.ceil(len(xaxis) / max_samples))
    edges = np.arange(len(xaxis))[::factor]
    counts = np.diff(edges)
    rs = np.cumsum(series) - series
    rs2 = np.cumsum(series**2) - series**2
    s1 = rs[edges[1:]] - rs[edges[:-1]]
    s2 = rs2[edges[1:]] - rs2[edges[:-1]]
    mean = s1 / counts
    var = s2 / counts - s1**2 / counts**2 + 1e-8
    return xaxis[edges[1:]], mean, np.sqrt(var)


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_losses(loss_file, output_dir, smooth=True):
    """One plot of each losses.txt column (jpg and pdf) and a gallery of them."""
    plt = _pyplot()
    os.makedirs(output_dir, exist_ok=True)
    with open(loss_file, "r") as f:
        keys = f.readline().split()[3:]
    table = np.loadtxt(loss_file, skiprows=1, ndmin=2)
    epochs, batch, steps = table[:, 0], table[:, 1], table[:, 2]
    losses = table[:, 3:3 + len(keys)]
    if np.max(epochs) == 0:
        xaxis, xlabel = steps, "Steps"
    else:
        xaxis, xlabel = epochs + batch / max(np.max(batch), 1), "Epoch"

    for i, key in enumerate(keys):
        fig, ax = plt.subplots()
        series = losses[:, i]
        if len(xaxis) > 2 and smooth:
            xs, mean, std = _smooth(xaxis, series)
            ax.plot(xs, mean, "b")
            ax.plot(xs, mean + std, c="0.5", linestyle="--")
            ax.plot(xs, mean - std, c="0.5", linestyle="--")
            final = mean[-1]
        else:
            ax.plot(xaxis, series, "b")
            final = series[-1]
        ax.set_xlabel(xlabel)
        ax.set_ylabel(key)
        ax.set_title(f"{key}: {final:.3f}")
        ax.grid(True)
        fig.savefig(os.path.join(output_dir, f"{key}.jpg"))
        fig.savefig(os.path.join(output_dir, f"{key}.pdf"))
        plt.close(fig)
    image_gallery.create_simple_gallery(output_dir)


def plot_validation(training_file, validation_file, output_dir, smooth=True):
    """Training loss against validation loss by epoch (jpg and pdf), and a gallery."""
    plt = _pyplot()
    os.makedirs(output_dir, exist_ok=True)
    tdata = np.loadtxt(training_file, skiprows=1, ndmin=2)
    vdata = np.loadtxt(validation_file, skiprows=1, ndmin=2)
    xaxis = tdata[:, 0] + tdata[:, 1] / max(np.max(tdata[:, 1]), 1)
    tloss = tdata[:, 3]

    fig, ax = plt.subplots()
    if len(tloss) > 2 and smooth:
        xs, mean, _ = _smooth(xaxis, tloss)
        ax.plot(xs, mean, "b", label="train")
        final_train = mean[-1]
    else:
        ax.plot(xaxis, tloss, "b", label="train")
        final_train = tloss[-1]
    ax.plot(vdata[:, 0] + 1, vdata[:, 1], "r", label="val")
    ax.set_xlabel("Epoch")
    ax.set_ylabel("Loss")
    ax.set_title(f"Training ({final_train:.3f}) vs. Validation Loss ({vdata[-1, 1]:.3f})")
    ax.grid(True)
    ax.legend(loc="best")
    fig.savefig(os.path.join(output_dir, "training_validation_loss.jpg"))
    fig.savefig(os.path.join(output_dir, "training_validation_loss.pdf"))
    plt.close(fig)
    image_gallery.create_simple_gallery(output_dir)


def _image_id(filename: str) -> int:
    return int(hashlib.sha1(filename.encode()).hexdigest(), 16) % 1000000000


def _save_rgb(path, image):
    from PIL import Image

    arr = np.clip((np.asarray(image) + 1) * 0.5, 0, 1)
    Image.fromarray(np.uint8(arr * 255)).save(path)


def log_debug_images(epoch, step, batch_idx, inputs, outputs, output_dir):
    """Colormapped idepth estimates of sample ``batch_idx`` at every level, its input
    and truth, with a training-evolution gallery per level (reference :291-404).
    ``inputs`` holds ``left_filenames``, ``left_image_pyr`` and optionally
    ``left_idepthmap_true``; ``outputs`` holds ``left_idepthmap_pyr``."""
    from PIL import Image

    os.makedirs(output_dir, exist_ok=True)
    left_file = inputs["left_filenames"][batch_idx]
    image_id = _image_id(left_file)

    ids_file = os.path.join(output_dir, "image_ids.txt")
    known = set()
    if os.path.exists(ids_file):
        with open(ids_file) as f:
            known = {line.split()[0] for line in f.readlines()[1:]}
    else:
        with open(ids_file, "w") as f:
            f.write("left_id left_filename\n")
    if str(image_id) not in known:
        with open(ids_file, "a") as f:
            f.write(f"{image_id} {left_file}\n")

    truth = inputs.get("left_idepthmap_true")
    vmax = float(np.max(np.asarray(truth)[batch_idx])) if truth is not None else None

    for lvl, est in enumerate(outputs["left_idepthmap_pyr"]):
        if est is None:
            continue
        lvl_dir = os.path.join(output_dir, f"left_idepthmap{lvl}")
        os.makedirs(lvl_dir, exist_ok=True)
        _save_rgb(os.path.join(lvl_dir, f"{image_id}_left_input.jpg"),
                  np.asarray(inputs["left_image_pyr"][0])[batch_idx])
        if truth is not None:
            rgb = apply_cmap(np.asarray(truth)[batch_idx], 0.0, vmax)
            Image.fromarray(np.uint8(rgb[..., :3] * 255)).save(
                os.path.join(lvl_dir, f"{image_id}_left_ground_truth.jpg"))
        rgb = apply_cmap(np.asarray(est)[batch_idx], 0.0, vmax)
        Image.fromarray(np.uint8(rgb[..., :3] * 255)).save(
            os.path.join(lvl_dir, f"{image_id}_{epoch:04d}.jpg"))
        image_gallery.create_training_gallery(lvl_dir)


def _mask_image(mask):
    """A boolean mask (a tensor on any device or an array; unit axes squeezed) as an 8-bit
    grayscale image: 255 where set."""
    from PIL import Image

    if hasattr(mask, "detach"):
        mask = mask.detach().cpu()
    return Image.fromarray(np.asarray(mask).squeeze().astype(np.uint8) * 255, "L")


def log_debug_occlusion_mask(epoch, step, image_id, mask, truth, output_dir):
    """A boolean occlusion mask as ``<image_id>_<epoch>.jpg`` and, when ``truth`` is given,
    the true mask as ``<image_id>_true.jpg`` (reference
    multi_view_stereonet_utils.py:272-289)."""
    os.makedirs(output_dir, exist_ok=True)
    _mask_image(mask).save(os.path.join(output_dir, f"{image_id}_{epoch:04d}.jpg"))
    if truth is not None:
        _mask_image(truth).save(os.path.join(output_dir, f"{image_id}_true.jpg"))

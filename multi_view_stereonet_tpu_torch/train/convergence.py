"""Training from scratch to a falling validation EPE, with a resume mid-run.

Port of the JAX repository's convergence script (``scripts/run_convergence.py:38-161``):
the full supervised recipe through the train CLI's ``train`` on a GTA-SfM tree, its
split cut 80/20 by lines into a training and a held-out split, trained to
``epochs_first`` and stopped, then trained on by a second call that resumes from the
last epoch checkpoint to ``epochs_total``. The losses, the validation file, the final
weights and a ``SUMMARY_<tag>.md`` are copied into a destination directory. The loss
plots are drawn there once, after training, from the copied losses file (``draw_plots``;
where matplotlib is not installed, later, by the same function).

The tree comes from the caller (``scripts/run_convergence_torch.py`` writes the JAX
script's synthetic tree); the package never writes one. Training runs on ``device``:
the card unless the caller names the CPU, with no fallback.
"""

from __future__ import annotations

import importlib.util
import os
import shutil
import tempfile
import time

from ..checkpoint import native as ckpt
from .config import load_params_yaml
from .logging import plot_losses
from .train_cli import train

TRAIN_SHARE = 0.8  # the share of split lines trained on (``run_convergence.py:80-82``)
PLOTS = ("loss.jpg", "supervised_loss.jpg")


def hold_out(split: str, work: str) -> tuple:
    """Cut ``split`` by lines: the first 80% into ``<work>/train_gta_sfm.txt``, the rest
    into ``<work>/val_gta_sfm.txt`` (``run_convergence.py:80-88``). Returns (train
    split, held-out split, n_train, n_val)."""
    with open(split) as f:
        lines = [line for line in f if line.strip()]
    n_train = int(len(lines) * TRAIN_SHARE)
    train_split = os.path.join(work, "train_gta_sfm.txt")
    val_split = os.path.join(work, "val_gta_sfm.txt")
    with open(train_split, "w") as f:
        f.writelines(lines[:n_train])
    with open(val_split, "w") as f:
        f.writelines(lines[n_train:])
    return train_split, val_split, n_train, len(lines) - n_train


def convergence_config(size=(96, 128), batch=4, epochs_total=60, augment=False,
                       transfer_u8=False) -> dict:
    """The reference defaults with the JAX script's overrides
    (``run_convergence.py:90-103``): supervision alone, adam at 1e-3, a plot every 50
    steps, debug images all but off. ``run_convergence`` trains with ``plot_freq`` 0 and
    draws the plots after the run instead."""
    cfg = load_params_yaml(None)
    cfg.update({
        "size": list(size),
        "batch_size": batch,
        "num_epochs": epochs_total,
        "augment": augment,
        "transfer_u8": transfer_u8,
        "supervision_factor": 1.0,
        "reconstruction_factor": 0.0,
        "left_right_factor": 0.0,
        "learning_rate": 1e-3,
        "debug_image_freq": 10_000,
        "plot_freq": 50,
    })
    return cfg


def read_table(path: str) -> tuple:
    """(header, rows) of a whitespace table with a header line (losses.txt,
    validation.txt); the columns are found by name, as their order is the metric
    dict's."""
    with open(path) as f:
        lines = [line.split() for line in f if line.strip()]
    return lines[0], lines[1:]


def validation_curve(path: str) -> dict:
    """{column: [values by epoch]} of a validation.txt, "epoch" as ints."""
    header, rows = read_table(path)
    curve = {name: [float(r[i]) for r in rows] for i, name in enumerate(header)}
    curve["epoch"] = [int(e) for e in curve["epoch"]]
    return curve


def check_continued(losses_path: str, validation_path: str, epochs_total: int) -> None:
    """The resumed run went on where the first stopped: validation.txt holds epochs
    0..epochs_total-1 once each, and losses.txt's steps run 1, 2, 3... with each epoch's
    batches in order. Raises ValueError otherwise."""
    epochs = validation_curve(validation_path)["epoch"]
    if epochs != list(range(epochs_total)):
        raise ValueError(f"{validation_path}: epochs {epochs}, not 0..{epochs_total - 1}")
    header, rows = read_table(losses_path)
    e, b, s = (header.index(k) for k in ("epoch", "batch", "step"))
    previous = (-1, -1, 0)
    for row in rows:
        epoch, batch, step = int(row[e]), int(row[b]), int(row[s])
        batch_follows = batch == previous[1] + 1 if epoch == previous[0] else (
            epoch == previous[0] + 1 and batch == 0)
        if step != previous[2] + 1 or not batch_follows:
            raise ValueError(f"{losses_path}: (epoch, batch, step) {(epoch, batch, step)} "
                             f"does not follow {previous}")
        previous = (epoch, batch, step)


def run_convergence(data_dir: str, split: str, work: str, dest: str, *, size=(96, 128),
                    batch=4, augment=False, transfer_u8=False, epochs_first=30,
                    epochs_total=60, tag="", device=None, init_weights_dir="",
                    overrides=None, describe="", reference=None) -> dict:
    """Train from scratch on ``split``'s first 80% under ``work/run``, validating on the
    rest each epoch: to ``epochs_first``, then resumed to ``epochs_total``. Copies into
    ``dest``: ``losses_<tag>.txt``, ``validation_<tag>.txt``, the loss plots drawn from
    the copied losses file (where matplotlib is installed), the final weights as
    ``<tag>/stereo_network.pth`` and ``SUMMARY_<tag>.md`` (no suffix for an empty tag, the
    weights then under ``run/``).

    ``init_weights_dir`` starts the first call from that directory's weights
    (``previous_checkpoint_dir``) instead of the seed's init; ``overrides`` update the
    config after this module's own; ``describe`` is the tree and card, written into the
    summary; ``reference`` is (label, validation.txt) of another run to set beside this
    one's. Returns the summary's numbers."""
    os.makedirs(work, exist_ok=True)
    train_split, val_split, n_train, n_val = hold_out(split, work)
    cfg = convergence_config(size, batch, epochs_total, augment, transfer_u8)
    cfg.update(overrides or {})
    run_cfg = dict(cfg, plot_freq=0)
    out = os.path.join(work, "run")

    t0 = time.perf_counter()
    print(f"=== phase 1: epochs 0..{epochs_first - 1} ===", flush=True)
    train(dict(run_cfg, previous_checkpoint_dir=init_weights_dir), data_dir, train_split,
          val_split, out, max_epochs=epochs_first, device=device)
    print(f"=== phase 2: resume -> epoch {epochs_total - 1} ===", flush=True)
    train(run_cfg, data_dir, train_split, val_split, out, max_epochs=epochs_total,
          device=device)
    seconds = time.perf_counter() - t0

    losses, validation = os.path.join(out, "losses.txt"), os.path.join(out, "validation.txt")
    check_continued(losses, validation, epochs_total)
    os.makedirs(dest, exist_ok=True)
    suffix = f"_{tag}" if tag else ""
    for path in (losses, validation):
        name = os.path.basename(path)
        shutil.copy(path, os.path.join(dest, name.replace(".txt", suffix + ".txt")))
    if can_plot():
        draw_plots(dest, tag)
    weights = os.path.join(dest, tag or "run")
    os.makedirs(weights, exist_ok=True)
    shutil.copy(os.path.join(ckpt.epoch_dir(os.path.join(out, "checkpoints"),
                                            epochs_total - 1), ckpt.PARAMS_FILE), weights)

    curve = validation_curve(validation)
    summary = {"tag": tag, "n_train": n_train, "n_val": n_val, "epochs_first": epochs_first,
               "epochs_total": epochs_total, "seconds": seconds,
               **summarize(curve)}
    with open(os.path.join(dest, f"SUMMARY{suffix}.md"), "w") as f:
        f.write(summary_markdown(summary, cfg, describe, reference))
    print(f"validation EPE: epoch 0: {curve['epe'][0]:.3f} -> best {summary['best_epe']:.3f} "
          f"(epoch {summary['best_epoch']}) -> epoch {curve['epoch'][-1]}: "
          f"{curve['epe'][-1]:.3f}; refined_zero_frac 0 from epoch "
          f"{summary['alive_from']}", flush=True)
    return summary


def can_plot() -> bool:
    """Whether matplotlib, which the loss plots need, is installed."""
    return importlib.util.find_spec("matplotlib") is not None


def draw_plots(dest: str, tag: str = "") -> None:
    """``loss_<tag>.jpg`` and ``supervised_loss_<tag>.jpg`` in ``dest``, drawn from its
    ``losses_<tag>.txt`` by the train CLI's ``plot_losses`` (the plots the JAX script
    copies from its run directory, over the whole run)."""
    suffix = f"_{tag}" if tag else ""
    with tempfile.TemporaryDirectory() as tmp:
        plot_losses(os.path.join(dest, f"losses{suffix}.txt"), tmp)
        for name in PLOTS:
            shutil.copy(os.path.join(tmp, name),
                        os.path.join(dest, name.replace(".jpg", suffix + ".jpg")))


def summarize(curve: dict) -> dict:
    """Epoch 0, best (lowest EPE) and final validation loss, EPE and
    ``refined_zero_frac``, and the first epoch from which ``refined_zero_frac`` stays 0
    (None if it never does)."""
    epe = curve["epe"]
    best = min(range(len(epe)), key=epe.__getitem__)
    zero = curve["refined_zero_frac"]
    alive = [i for i in range(len(zero)) if all(z == 0.0 for z in zero[i:])]
    rows = {"first": 0, "best": best, "final": len(epe) - 1}
    return {"best_epoch": curve["epoch"][best], "best_epe": epe[best],
            "alive_from": curve["epoch"][alive[0]] if alive else None,
            "table": {k: {"epoch": curve["epoch"][i], "loss": curve["loss"][i],
                          "epe": epe[i], "refined_zero_frac": zero[i]}
                      for k, i in rows.items()}}


def summary_markdown(summary: dict, cfg: dict, describe: str, reference=None) -> str:
    """The run's table (epoch 0, best, final) with another run's beside it."""
    lines = [f"# Convergence run of the PyTorch port ({summary['tag'] or 'plane'})", "",
             describe, "",
             f"Recipe: size {cfg['size']}, batch {cfg['batch_size']}, adam "
             f"{cfg['learning_rate']}, supervision only, augment={cfg['augment']}, "
             f"transfer_u8={cfg['transfer_u8']}, {summary['n_train']} train / "
             f"{summary['n_val']} held-out samples; {summary['epochs_total']} epochs, "
             f"stopped after epoch {summary['epochs_first'] - 1} and resumed from its "
             f"checkpoint by a second `train` call (epochs and steps continued: checked). "
             f"Both calls took {summary['seconds']:.1f} s.", "",
             "| run | row | epoch | validation loss | EPE (px) | refined_zero_frac |",
             "| --- | --- | --- | --- | --- | --- |"]

    def rows(label, table):
        for name in ("first", "best", "final"):
            r = table[name]
            lines.append(f"| {label} | {name} | {r['epoch']} | {r['loss']:.4f} | "
                         f"{r['epe']:.4f} | {r['refined_zero_frac']:.4f} |")
    rows("this run", summary["table"])
    if reference is not None:
        label, path = reference
        rows(label, summarize(validation_curve(path))["table"])
    lines += ["", "The loss plots are drawn after the run from the copied losses file "
              "(`draw_plots`; `scripts/run_convergence_torch.py --replot` where matplotlib "
              "is not installed)."]
    alive = summary["alive_from"]
    lines += ["", f"`refined_zero_frac` is 0 at every epoch from epoch {alive} on." if alive
              is not None else "`refined_zero_frac` is above 0 at the last epoch.", ""]
    return "\n".join(lines)

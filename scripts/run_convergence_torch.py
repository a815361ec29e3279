#!/usr/bin/env python3
"""Train the PyTorch port from scratch on a synthetic GTA-SfM tree, with a resume.

The port's counterpart of ``scripts/run_convergence.py``, with the same flags and the
same epoch variables, so a reproduce line of the JAX script maps one to one:

    CONV_EPOCHS_FIRST=75 CONV_EPOCHS_TOTAL=200 \\
        python scripts/run_convergence_torch.py /tmp/conv --scene layered_track

It writes the JAX script's tree (``tests/synthetic_data.make_gta_sfm_tree``, seed 7)
under the workdir, trains through ``multi_view_stereonet_tpu_torch.train.convergence``
on the card (``--device cpu`` to train on the CPU), one checkpoint an epoch under
``<workdir>/run/checkpoints``, and copies the curves, plots, final weights
(``<tag>/stereo_network.pth``) and ``SUMMARY_<tag>.md`` into ``--dest``
(``docs/convergence_torch/``). The JAX run of the same tag, where
``docs/convergence/validation_<tag>.txt`` holds one, is set beside this one in the
summary as a TPU run. The workdir defaults to a directory under the temp directory.
Where matplotlib is not installed (the card's machine) the loss plots are drawn later,
from the copied losses file: the same command with ``--replot``.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from multi_view_stereonet_tpu_torch.train.convergence import (  # noqa: E402
    draw_plots, run_convergence)

EPOCHS_FIRST = int(os.environ.get("CONV_EPOCHS_FIRST", 30))
EPOCHS_TOTAL = int(os.environ.get("CONV_EPOCHS_TOTAL", 60))
TREE_SEED = 7


def synthetic_data():
    """tests/synthetic_data.py, loaded by path: an installed package named ``tests``
    may shadow the repository's."""
    spec = importlib.util.spec_from_file_location(
        "synthetic_data", os.path.join(REPO, "tests", "synthetic_data.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def make_tree(work, scene, size, sequences, frames):
    """The JAX script's tree (``run_convergence.py:75-77``): (data_dir, split)."""
    return synthetic_data().make_gta_sfm_tree(
        work, num_sequences=sequences, frames=frames, rows=size[0], cols=size[1],
        seed=TREE_SEED, scene=scene)


def card_description(device) -> str:
    """The card's ``nvidia-smi`` name and power limit, or the CPU."""
    if device == "cpu":
        return "the CPU"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout
    return out.strip().splitlines()[0]


def parser():
    ap = argparse.ArgumentParser(description=__doc__, allow_abbrev=False,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("workdir", nargs="?", default=None)
    ap.add_argument("--scene", default="plane", choices=("plane", "layered", "layered_track"))
    ap.add_argument("--size", type=int, nargs=2, default=(96, 128), metavar=("ROWS", "COLS"))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--sequences", type=int, default=2)
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--augment", action="store_true", help="the recipe's color jitter")
    ap.add_argument("--transfer_u8", action="store_true",
                    help="uint8 image transport, dequantized on the device")
    ap.add_argument("--tag", default=None,
                    help="artifact suffix (default: the scene name, none for plane)")
    ap.add_argument("--device", default="cuda", help="'cpu' trains on the CPU")
    ap.add_argument("--init_weights", default="",
                    help="a directory whose stereo_network.pth the run starts from, instead "
                         "of the seed's init (e.g. the JAX package's init, converted)")
    ap.add_argument("--dest", default=os.path.join(REPO, "docs", "convergence_torch"),
                    help="where the curves, weights and summary go")
    ap.add_argument("--replot", action="store_true",
                    help="train nothing: draw the loss plots of the tag's losses file in "
                         "--dest (for a run made where matplotlib is not installed)")
    return ap


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    ns = parser().parse_args(argv)
    tag = ns.tag if ns.tag else ("" if ns.scene == "plane" else ns.scene)
    if ns.replot:
        draw_plots(ns.dest, tag)
        return
    work = ns.workdir or os.path.join(tempfile.gettempdir(),
                                      f"convergence_torch_{tag or ns.scene}")
    os.makedirs(work, exist_ok=True)
    data_dir, split = make_tree(work, ns.scene, ns.size, ns.sequences, ns.frames)
    jax_run = os.path.join(REPO, "docs", "convergence", f"validation_{tag}.txt")
    reference = (("JAX package, TPU (docs/convergence/validation_" + tag + ".txt)",
                  jax_run) if tag and os.path.exists(jax_run) else None)
    describe = (f"Synthetic GTA-SfM {ns.scene} tree ({ns.size[0]}x{ns.size[1]}, "
                f"{ns.sequences} sequences x {ns.frames} frames, seed {TREE_SEED}), trained on "
                f"{card_description(ns.device)} by\n`CONV_EPOCHS_FIRST={EPOCHS_FIRST} "
                f"CONV_EPOCHS_TOTAL={EPOCHS_TOTAL} python scripts/run_convergence_torch.py "
                f"<work> {' '.join(a for a in argv if a != ns.workdir)}`.")
    run_convergence(data_dir, split, work, ns.dest, size=tuple(ns.size), batch=ns.batch,
                    augment=ns.augment, transfer_u8=ns.transfer_u8,
                    epochs_first=EPOCHS_FIRST, epochs_total=EPOCHS_TOTAL, tag=tag,
                    device=ns.device, init_weights_dir=ns.init_weights, describe=describe,
                    reference=reference)
    print(f"done; artifacts in {ns.dest}", flush=True)


if __name__ == "__main__":
    main()

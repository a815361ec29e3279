#!/usr/bin/env python3
"""Accuracy at speed of the PyTorch port: abs_rel, EPE, deviation and ms/frame per config.

The port's counterpart of ``scripts/accuracy_speed.py``, on the card (``--device cpu``
scores on the CPU, untimed). Two protocols:

- a convergence run's weights on its held-out split: ``--weights DIR`` (a directory
  holding ``stereo_network.pth``, e.g. ``docs/convergence_torch/layered_track``) and the
  run's tree flags (``--scene --size --sequences --frames``, as
  ``scripts/run_convergence_torch.py`` took them); the tree is written again from its
  seed and cut 80/20 as the run cut it, and the held-out 20% is scored;

      python scripts/accuracy_speed_torch.py --weights docs/convergence_torch/layered_track \\
          --scene layered_track --json ladder.json --markdown ladder.md

- without ``--weights``, the JAX script's canonical protocol with seeded weights
  (``random_state_dict(0)``): ``ACC_SCENE`` plane / slanted / layered,
  ``ACC_COMPARISONS``, ``ACC_ROWS`` / ``ACC_COLS`` (480x640), the tree at seed 0 and
  every line scored.

Config names after the flags pick from ``CONFIGS`` (all by default, "highest" first).
Prints a line a config, the table, and the card's ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

from multi_view_stereonet_tpu_torch.checkpoint import random_state_dict  # noqa: E402
from multi_view_stereonet_tpu_torch.eval.accuracy import (  # noqa: E402
    CONFIGS, ladder, markdown_table, split_batches)
from multi_view_stereonet_tpu_torch.eval.streaming import (  # noqa: E402
    load_model, serving_device)
from multi_view_stereonet_tpu_torch.models import MultiViewStereoNet  # noqa: E402
from multi_view_stereonet_tpu_torch.train.convergence import hold_out  # noqa: E402
from run_convergence_torch import card_description, make_tree, synthetic_data  # noqa: E402

D = 12  # hypotheses: the reference eval config's, and the convergence runs'
WEIGHTS_SEED = 0  # the seeded weights of the canonical protocol


def held_out_batches(work, scene, size, sequences, frames):
    """A convergence run's held-out split, batched (``split_batches``)."""
    data_dir, split = make_tree(work, scene, size, sequences, frames)
    _, val_split, _, _ = hold_out(split, work)
    return split_batches(data_dir, val_split, size[0], size[1])


def canonical_batches(work, scene, rows, cols, comparisons):
    """The JAX script's protocol (``accuracy_speed.py:22-61``, ``:134-139``)."""
    normal = (0.35, 0.25, 1.0) if scene == "slanted" else None
    data_dir, split = synthetic_data().make_gta_sfm_tree(
        work, rows=rows, cols=cols, frames=max(4, comparisons + 2), num_sequences=2,
        comparisons=comparisons, plane_normal=normal,
        scene="layered" if scene == "layered" else "plane")
    return split_batches(data_dir, split, rows, cols)


def parser():
    ap = argparse.ArgumentParser(description=__doc__, allow_abbrev=False,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("configs", nargs="*", metavar="CONFIG",
                    help=f"configs to score, of {', '.join(CONFIGS)} (default: all)")
    ap.add_argument("--weights", default=None, help="a directory with stereo_network.pth")
    ap.add_argument("--scene", default=None,
                    help="with --weights: the run's scene (plane, layered, layered_track); "
                         "without: ACC_SCENE (plane, slanted, layered)")
    ap.add_argument("--size", type=int, nargs=2, default=None, metavar=("ROWS", "COLS"),
                    help="with --weights: 96 128; without: ACC_ROWS ACC_COLS, 480 640")
    ap.add_argument("--sequences", type=int, default=2)
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--comparisons", type=int,
                    default=int(os.environ.get("ACC_COMPARISONS", 1)))
    ap.add_argument("--device", default="cuda", help="'cpu' scores on the CPU, untimed")
    ap.add_argument("--json", default=None, help="write the rows and the card here")
    ap.add_argument("--markdown", default=None, help="write the table here")
    return ap


def main(argv=None):
    ap = parser()
    ns = ap.parse_args(argv)
    unknown = [name for name in ns.configs if name not in CONFIGS]
    if unknown:
        ap.error(f"unknown configs {unknown}; known: {list(CONFIGS)}")
    device = serving_device(ns.device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as work:
        if ns.weights:
            scene, size = ns.scene or "plane", ns.size or (96, 128)
            batches = held_out_batches(work, scene, size, ns.sequences, ns.frames)
            model = load_model(ns.weights, device)
            protocol = (f"{ns.weights} on the held-out split of the {scene} tree "
                        f"({size[0]}x{size[1]}, {ns.sequences} x {ns.frames} frames)")
        else:
            scene = ns.scene or os.environ.get("ACC_SCENE", "plane")
            size = ns.size or (int(os.environ.get("ACC_ROWS", 480)),
                               int(os.environ.get("ACC_COLS", 640)))
            batches = canonical_batches(work, scene, size[0], size[1], ns.comparisons)
            model = MultiViewStereoNet()
            model.load_state_dict(random_state_dict(WEIGHTS_SEED))
            model = model.to(device).eval()
            protocol = (f"the canonical {scene} protocol ({size[0]}x{size[1]}, "
                        f"{ns.comparisons} comparison(s)), seeded weights {WEIGHTS_SEED}")
    card = card_description(ns.device)
    print(f"{protocol}: {sum(len(b['K']) for b in batches)} samples on {card}", flush=True)
    time_batch = {k: v[:1] for k, v in batches[0].items()}
    rows = ladder(model, batches, device, ns.configs or None,
                  {"num_idepth_samples": D}, time_batch)
    table = markdown_table(rows)
    print(table)
    if ns.json:
        with open(ns.json, "w") as f:
            json.dump({"protocol": protocol, "card": card, "torch": torch.__version__,
                       "rows": rows}, f, indent=1)
    if ns.markdown:
        with open(ns.markdown, "w") as f:
            f.write(f"Ladder: {protocol}; {card}; "
                    f"`scripts/accuracy_speed_torch.py`.\n\n{table}")
    print(card, flush=True)


if __name__ == "__main__":
    main()

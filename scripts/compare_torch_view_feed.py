#!/usr/bin/env python3
"""Time the train CLI's view-sharded recipe of two checkouts on one NVIDIA card, in turns.

    python scripts/compare_torch_view_feed.py PARENT_DIR CHANGE_DIR [--pairs 1]
                                              [--out FILE]

Each directory is a whole checkout (for example ``git archive`` of a commit, unpacked).
A run is the train CLI as two processes over gloo on the card (each started by its
checkout's ``chip_smoke.child``), ``mesh_view: 2`` at the recipe (global B = 8, 480x640,
D = 12, adam, augmentation on) over an 80-request V = 2 synthetic GTA-SfM tree, for 10
steps. Its number is each process's CLI loop in ms a step: the host clock at each
step's stop check, the median of steps 4-9. ``--pairs`` times the runs: the parent at
1 loader thread, the change at 1, 4, 4 and 1, the parent at 1 (a parent checkout that
refuses more than one thread with augmentation at ``mesh_view`` 2 is run at one only).
Prints every run with the card's name and power limit, and with ``--out FILE`` writes
them there as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

STEPS, SAMPLES = 10, 80


def smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run(tree: str, argv: list, timeout: float = 900) -> list:
    """Two processes of ``tree``'s ``chip_smoke.child`` on ``argv``: each one's ms a step."""
    port = free_port()
    specs = [json.dumps({"kind": "train", "argv": argv, "rank": r, "n": 2, "port": port})
             for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", f"import sys; sys.path.insert(0, {tree!r}); import chip_smoke; "
         f"chip_smoke.child({spec!r})"],
        cwd=tree, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for spec in specs]
    ms = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            if p.returncode != 0:
                raise RuntimeError(f"{tree}: a process exited {p.returncode}:\n{err[-3000:]}")
            stamps = json.loads(out.strip().splitlines()[-1])["stamps"]
            gaps = [b - a for a, b in zip(stamps[:-2], stamps[1:-1])][2:]
            ms.append(statistics.median(gaps) * 1e3)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return ms


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--pairs", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    parent, change = os.path.abspath(args.parent), os.path.abspath(args.change)
    card = smi()
    for tree in (parent, change):  # each checkout builds its kernels once, first
        subprocess.run([sys.executable, "-c", "import sys; sys.path.insert(0, '.'); "
                        "from multi_view_stereonet_tpu_torch.ops.cuda import build; "
                        "build.load_libraries('warp', 'incremental_chain', "
                        "'idepthmap_refiner', 'gn_apply')"], cwd=tree, check=True)
    sys.path.insert(0, change)
    import yaml

    import chip_smoke  # the change's; it loads tests/ by path
    from multi_view_stereonet_tpu_torch.train.config import load_params_yaml

    results = []
    with tempfile.TemporaryDirectory() as root:
        data_dir, split = chip_smoke.synthetic_data().make_gta_sfm_tree(
            os.path.join(root, "v2"), num_sequences=1, frames=SAMPLES + 2, rows=480,
            cols=640, seed=5, comparisons=2)
        cfg = load_params_yaml(None)
        cfg.update({"mesh_view": 2, "debug_image_freq": 0, "plot_freq": 0,
                    "num_epochs": 1, "print_freq": 1})
        order = [(parent, 1), (change, 1), (change, 4), (change, 4), (change, 1),
                 (parent, 1)] * args.pairs
        for i, (tree, workers) in enumerate(order):
            config = os.path.join(root, f"run{i}.yaml")
            with open(config, "w") as f:
                yaml.safe_dump(dict(cfg, num_workers=workers), f)
            ms = run(tree, ["--config", config, "--data_dir", data_dir, "--train_split",
                            split, "--output_dir", os.path.join(root, f"run{i}"),
                            "--max_steps", str(STEPS)])
            name = "parent" if tree == parent else "change"
            results.append({"tree": name, "num_workers": workers, "ms": ms})
            print(f"{name} at {workers} loader thread(s): the CLI loop {ms[0]:.3f} / "
                  f"{ms[1]:.3f} ms a step (process 0 / 1, median of steps 4-{STEPS - 1}) "
                  f"({card})", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "runs": results}, f, indent=1)


if __name__ == "__main__":
    main()

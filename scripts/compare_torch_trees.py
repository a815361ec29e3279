#!/usr/bin/env python3
"""Compare two checkouts of the PyTorch port on one NVIDIA card, in turns.

    python scripts/compare_torch_trees.py PARENT_DIR CHANGE_DIR [--pairs 6] [--out FILE]

Each directory is a whole checkout (for example ``git archive`` of a commit,
unpacked). The script runs, one process a run, in the order parent, change,
change, parent, ... (``--pairs`` of each):

- the serving forward at B = 1, V = 1, 480x640, D = 12 (cost filter and five
  refiners on, seeded fan-in-scale weights, random images, a synthetic
  camera): ms per frame, median of 3 x 30 forwards after 5 warm-ups (CUDA
  events around each 30);
- the incremental-chain kernel (K2) alone at N = 1 and 5, 30x40x32, D = 12:
  device time of one call, 20 calls replayed from a CUDA graph, median of 7;

then ``scripts/profile_torch_serving.py`` of each checkout, parent, change,
change, parent. Prints every run, the medians, the card's name and power
limit, and with ``--out FILE`` writes it all there as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

H0, W0, D = 480, 640, 12


def smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def measure(tree: str) -> dict:
    """One checkout's numbers, imported from ``tree`` (run in a child process)."""
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    from multi_view_stereonet_tpu_torch.checkpoint import random_state_dict
    from multi_view_stereonet_tpu_torch.eval.streaming import serving_forward
    from multi_view_stereonet_tpu_torch.models import (
        FeatureRefiner, MultiViewStereoNet, MultiViewStereoNetConfig)
    from multi_view_stereonet_tpu_torch.ops.cuda import incremental_chain as chain

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    K = np.eye(4, dtype=np.float32)
    K[0, 0] = K[1, 1] = 0.9 * W0
    K[0, 2], K[1, 2] = (W0 - 1) / 2.0, (H0 - 1) / 2.0
    T = np.eye(4, dtype=np.float32)[None, None].copy()
    T[0, 0, 0, 3] = 0.4
    batch = {"left_image": rng.uniform(-1, 1, (1, H0, W0, 3)),
             "right_images": rng.uniform(-1, 1, (1, 1, H0, W0, 3)),
             "K": K[None], "T_right_in_left": T}
    batch = {k: torch.as_tensor(np.asarray(v, np.float32)).to(dev) for k, v in batch.items()}
    model = MultiViewStereoNet()
    model.load_state_dict(random_state_dict(0))
    model = model.to(dev).eval()
    config = MultiViewStereoNetConfig(num_idepth_samples=D)

    def timed(fn, count):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(count):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / count

    result = {"tree": tree}
    with torch.inference_mode():
        for _ in range(5):
            serving_forward(model, batch, config)
        torch.cuda.synchronize()
        result["ms_per_frame"] = statistics.median(
            timed(lambda: serving_forward(model, batch, config), 30) for _ in range(3))

        prefix = "right_feature_extractor.refiner."
        refiner = FeatureRefiner(32)
        refiner.load_state_dict({k[len(prefix):]: v for k, v in random_state_dict(3).items()
                                 if k.startswith(prefix)})
        refiner = refiner.to(dev).eval()
        g = torch.Generator().manual_seed(1)
        for n in (1, 5):
            feats0 = torch.randn(n, 30, 40, 32, generator=g).to(dev)
            image_rest = (torch.rand(n, D - 1, 30, 40, 3, generator=g) * 2 - 1).to(dev)
            H_inc = torch.eye(3).repeat(n, D - 1, 1, 1)
            H_inc[..., 0, 2] = torch.rand(n, D - 1, generator=g) * 2 - 1
            H_inc = H_inc.to(dev)

            def call():
                return chain.incremental_chain_kernel(refiner, feats0, image_rest, H_inc)
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(3):
                    call()
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for _ in range(20):
                    call()
            graph.replay()
            torch.cuda.synchronize()
            result[f"k2_device_ms_n{n}"] = statistics.median(
                timed(graph.replay, 1) for _ in range(7)) / 20
    return result


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("parent")
    parser.add_argument("change")
    parser.add_argument("--pairs", type=int, default=6)
    parser.add_argument("--out", help="write every run and profile here as JSON")
    parser.add_argument("--child", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child:
        print(json.dumps(measure(os.path.abspath(args.child))), flush=True)
        return

    trees = {"parent": os.path.abspath(args.parent), "change": os.path.abspath(args.change)}
    order = (["parent", "change", "change", "parent"] * args.pairs)[:2 * args.pairs]
    runs = []
    for label in order:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), args.parent,
                               args.change, "--child", trees[label]], capture_output=True,
                              text=True, check=True)
        run = {"label": label, **json.loads(proc.stdout.strip().splitlines()[-1])}
        runs.append(run)
        print(f"{label}: {run['ms_per_frame']:.3f} ms/frame, K2 device "
              f"{run['k2_device_ms_n1']:.4f} ms at N=1, {run['k2_device_ms_n5']:.4f} at N=5",
              flush=True)
    summary = {}
    for label in trees:
        mine = [r for r in runs if r["label"] == label]
        summary[label] = {key: statistics.median(r[key] for r in mine)
                          for key in ("ms_per_frame", "k2_device_ms_n1", "k2_device_ms_n5")}
        print(f"{label} medians: {summary[label]}", flush=True)

    profiles = []
    for label in ("parent", "change", "change", "parent"):
        proc = subprocess.run([sys.executable, "scripts/profile_torch_serving.py"],
                              cwd=trees[label], capture_output=True, text=True, check=True)
        profiles.append({"label": label, "output": proc.stdout})
        print(f"profile {label}: {proc.stdout.strip().splitlines()[-2]}", flush=True)
    card = smi()
    print(card, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "runs": runs, "summary": summary, "profiles": profiles},
                      f, indent=1)


if __name__ == "__main__":
    main()

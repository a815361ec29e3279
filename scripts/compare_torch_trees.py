#!/usr/bin/env python3
"""Compare two checkouts of the PyTorch port on one NVIDIA card, in turns.

    python scripts/compare_torch_trees.py PARENT_DIR CHANGE_DIR [--pairs 6] [--out FILE]
        [--backward [--k1-only] | --train-step [--two-view]]

Each directory is a whole checkout (for example ``git archive`` of a commit,
unpacked). The script runs, one process a run, in the order parent, change,
change, parent, ... (``--pairs`` of each):

- the serving forward at B = 1, V = 1, 480x640, D = 12 (cost filter and five
  refiners on, seeded fan-in-scale weights, random images, a synthetic
  camera): ms per frame, median of 3 x 30 forwards after 5 warm-ups (CUDA
  events around each 30), and the SHA-256 of its output's bytes, so that the
  two trees' outputs are compared bit for bit;
- the incremental-chain kernel (K2) alone at N = 1 and 5, 30x40x32, D = 12:
  device time of one call, 20 calls replayed from a CUDA graph, median of 7;
- the idepthmap-refiner kernel (K3) alone at (N, 35, h, w) = (1, 35, 30, 40),
  (8, 35, 30, 40) and (1, 35, 60, 80): the same device time, and a call's time
  with its host work (CUDA events around 30 calls, median of 3);

then ``scripts/profile_torch_serving.py`` of each checkout, parent, change,
change, parent. Prints every run, the medians, the card's name and power
limit, and with ``--out FILE`` writes it all there as JSON.

With ``--backward`` each run times instead the backward of K2's and K3's
``autograd.Function`` (the call every tree of the port has, whatever its backward launches):
20 backwards captured in a CUDA graph on the stream their forward ran on, the graph's
device time over 20, median of 7 replays; K2 at N = 1 and 8, 30x40x32, D = 12 (the
gradients of feats0 and the weights, the recipe's), K3 at (N, 35, h, w) = (1, 35, 30, 40),
(8, 35, 30, 40), (1, 35, 60, 80) and the recipe's (8, 35, 60, 80) (the guidance's, the
idepth map's and the weights'); K1's (``warp.grid_sample``'s Function) at each of a
two-view step's calls and at the other shapes the records time (``chip_smoke.py``
``k1_step_calls``, of this script's checkout, and ``k1_other_calls``), each with its
gradients, beside ``F.grid_sample``'s autograd for the same gradients on the same data
in the same run, and the sum of a step's 20 calls of each. ``--k1-only`` times K1's
alone.

With ``--train-step`` each run times instead the recipe's train step (B = 8, V = 1,
480x640, D = 12, cost filter and five refiners on, adam 1e-3, augmentation on;
``chip_smoke.py`` phase 7's) on one batch of a synthetic GTA-SfM tree from seeded
fan-in-scale weights, on the kernel path: ms a step (CUDA events around each of 4 steps
after 2 warm-up steps, the median), peak memory over those steps, device busy a step
(``chip_smoke.profile_kernels``) with ``aten::native_group_norm``'s calls and device time
and its backward's, and the K3 (refiner) forward and backward launches of one step; and,
first, the loss and every parameter's gradient of one step from the seeded weights, saved
beside the tree, so that the first change run's are held to the first parent run's
(chip_smoke.py's LOSS_BAR and GRAD_BAR: the kernel path against plain autograd).
``--two-view`` takes the two-view recipe's step instead (phase 8's: the right view's
forward and every loss, ``chip_smoke.TWO_VIEW_FACTORS``), whose losses call K1's backward
20 times.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys

H0, W0, D = 480, 640, 12
K3_SHAPES = ((1, 30, 40, "refiner4"), (8, 30, 40, "refiner4"), (1, 60, 80, "refiner3"))
K3_KEYS = tuple(f"k3_{what}_ms_{n}x{h}x{w}" for n, h, w, _ in K3_SHAPES
                for what in ("device", "call"))
K3_BACKWARD_SHAPES = K3_SHAPES + ((8, 60, 80, "refiner3"),)


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
        FeatureRefiner, IDepthmapRefiner, MultiViewStereoNet, MultiViewStereoNetConfig)
    from multi_view_stereonet_tpu_torch.ops.cuda import incremental_chain as chain
    from multi_view_stereonet_tpu_torch.ops.cuda import refiner as refiner_op

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

    def device_ms(call):
        """One call's device time: 20 calls replayed from a CUDA graph, median of 7."""
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
        return statistics.median(timed(graph.replay, 1) for _ in range(7)) / 20

    result = {"tree": tree}
    with torch.inference_mode():
        for _ in range(5):
            serving_forward(model, batch, config)
        torch.cuda.synchronize()
        result["ms_per_frame"] = statistics.median(
            timed(lambda: serving_forward(model, batch, config), 30) for _ in range(3))
        result["output_sha256"] = hashlib.sha256(
            serving_forward(model, batch, config).cpu().numpy().tobytes()).hexdigest()

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

            result[f"k2_device_ms_n{n}"] = device_ms(
                lambda: chain.incremental_chain_kernel(refiner, feats0, image_rest, H_inc))

        state = random_state_dict(4)
        for n, h, w, name in K3_SHAPES:
            with torch.inference_mode(False):  # parameters with version counters
                module = IDepthmapRefiner(35)
                module.load_state_dict({k[len(name) + 1:]: v for k, v in state.items()
                                        if k.startswith(name + ".")})
                module = module.to(dev).eval()
            guidance = (torch.rand(n, 35, h, w, generator=g) * 2 - 1).to(dev)
            idepth = (torch.rand(n, h, w, generator=g) * 20).to(dev)

            def call():
                return refiner_op.idepthmap_refiner(module, guidance, idepth, impl="kernel")
            for _ in range(5):
                call()
            torch.cuda.synchronize()
            result[f"k3_call_ms_{n}x{h}x{w}"] = statistics.median(
                timed(call, 30) for _ in range(3))
            result[f"k3_device_ms_{n}x{h}x{w}"] = device_ms(call)
    return result


def chip_smoke_module():
    """This script's checkout's ``chip_smoke.py`` as a module; its package imports come
    from the tree first on ``sys.path``."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def k1_other_calls(smoke, dev, g):
    """K1's backward at the shapes the records time beside a two-view step's calls, in
    ``smoke.k1_step_calls``' form with no calls a step: the losses' (8, 480, 640, 3) with
    both gradients (chip_smoke's phase 3b leaves) and the (1, 480, 640, 3) min-idepth
    warp's homography grid, with both."""
    import torch

    from multi_view_stereonet_tpu_torch.geometry import (
        build_K_pyramid, create_idepth_samples, create_plane_sweep_homographies,
        normalize_baseline)
    from multi_view_stereonet_tpu_torch.ops import homography_grid
    from multi_view_stereonet_tpu_torch.train.pipeline import pyramid_sizes

    H0, W0, B = smoke.H0, smoke.W0, smoke.TRAIN_B
    K, T = smoke.scene(1, 1)
    T, _ = normalize_baseline(T)
    K_pyr = build_K_pyramid(K, pyramid_sizes(H0, W0, smoke.NUM_LEVELS))
    samples = create_idepth_samples(T, K_pyr[4], 30, 40, smoke.D)
    warp_grid = homography_grid(create_plane_sweep_homographies(T, K_pyr[0],
                                                                samples[:, :1])[:, 0], H0, W0)
    return [{"label": f"({B},{H0},{W0},3) losses, both gradients",
             "image": (torch.rand(B, H0, W0, 3, generator=g) * 2 - 1).to(dev),
             "grid": smoke.loss_grid(B, dev, g), "needs": (True, True), "calls": 0},
            {"label": f"(1,{H0},{W0},3) min-idepth warp, both gradients",
             "image": (torch.rand(1, H0, W0, 3, generator=g) * 2 - 1).to(dev),
             "grid": warp_grid, "needs": (True, True), "calls": 0}]


def measure_k1_backward(smoke, dev) -> dict:
    """K1's backward through its Function and ``F.grid_sample``'s autograd, at each call of
    ``smoke.k1_step_calls`` and ``k1_other_calls``, timed by ``smoke.backward_graph_ms``;
    and each one's sum over a step's calls."""
    import torch
    import torch.nn.functional as F

    from multi_view_stereonet_tpu_torch.ops.cuda import warp

    g = torch.Generator().manual_seed(5)
    result = {"k1_step_ms": 0.0, "k1_library_step_ms": 0.0}
    for c in smoke.k1_step_calls(dev, g) + k1_other_calls(smoke, dev, g):
        image = c["image"].requires_grad_(c["needs"][0])
        grid = c["grid"].requires_grad_(c["needs"][1])
        leaves = [t for t, need in zip((image, grid), c["needs"]) if need]
        x = c["image"].detach().permute(0, 3, 1, 2).contiguous().requires_grad_(c["needs"][0])
        grid4 = c["grid"].detach().clone().requires_grad_(c["needs"][1])
        lib_leaves = [t for t, need in zip((x, grid4), c["needs"]) if need]
        ms = smoke.backward_graph_ms(lambda: warp.grid_sample(image, grid)[0], leaves)
        lib = smoke.backward_graph_ms(lambda: F.grid_sample(
            x, grid4, mode="bilinear", padding_mode="border", align_corners=False),
            lib_leaves)
        result[f"k1_backward_ms {c['label']}"] = ms
        result[f"k1_library_ms {c['label']}"] = lib
        result["k1_step_ms"] += c["calls"] * ms
        result["k1_library_step_ms"] += c["calls"] * lib
    return result


def measure_backward(tree: str, k1_only: bool = False) -> dict:
    """One checkout's backward times (``--backward``), imported from ``tree``; each
    backward timed by ``chip_smoke.backward_graph_ms`` (of this script's checkout)."""
    sys.path.insert(0, tree)
    import torch

    from multi_view_stereonet_tpu_torch.checkpoint import random_state_dict
    from multi_view_stereonet_tpu_torch.models import FeatureRefiner, IDepthmapRefiner
    from multi_view_stereonet_tpu_torch.ops.cuda import incremental_chain as chain
    from multi_view_stereonet_tpu_torch.ops.cuda import refiner as refiner_op

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(2)
    smoke = chip_smoke_module()
    backward_ms = smoke.backward_graph_ms

    result = {"tree": tree}
    result.update(measure_k1_backward(smoke, dev))
    if k1_only:
        return result
    prefix = "right_feature_extractor.refiner."
    refiner = FeatureRefiner(32)
    refiner.load_state_dict({k[len(prefix):]: v for k, v in random_state_dict(3).items()
                             if k.startswith(prefix)})
    refiner = refiner.to(dev)
    for n in (1, 8):
        feats0 = torch.randn(n, 30, 40, 32, generator=g).to(dev).requires_grad_()
        image_rest = (torch.rand(n, D - 1, 30, 40, 3, generator=g) * 2 - 1).to(dev)
        H_inc = torch.eye(3).repeat(n, D - 1, 1, 1)
        H_inc[..., 0, 2] = torch.rand(n, D - 1, generator=g) * 2 - 1
        H_inc = H_inc.to(dev)
        result[f"k2_backward_ms_n{n}"] = backward_ms(
            lambda: chain.incremental_chain(refiner, feats0, image_rest, H_inc),
            [feats0, *refiner.parameters()])
    state = random_state_dict(4)
    for n, h, w, name in K3_BACKWARD_SHAPES:
        module = IDepthmapRefiner(35)
        module.load_state_dict({k[len(name) + 1:]: v for k, v in state.items()
                                if k.startswith(name + ".")})
        module = module.to(dev)
        guidance = ((torch.rand(n, 35, h, w, generator=g) * 2 - 1).to(dev)
                    .requires_grad_())
        idepth = (torch.rand(n, h, w, generator=g) * 20).to(dev).requires_grad_()
        result[f"k3_backward_ms_{n}x{h}x{w}"] = backward_ms(
            lambda: refiner_op.idepthmap_refiner(module, guidance, idepth),
            [guidance, idepth, *module.parameters()])
    return result


def measure_train_step(tree: str, two_view: bool = False) -> dict:
    """One checkout's train-step numbers (``--train-step``), imported from ``tree``; with
    ``two_view`` the two-view recipe's (``--two-view``)."""
    sys.path.insert(0, tree)
    import tempfile

    import numpy as np
    import torch

    import chip_smoke
    from multi_view_stereonet_tpu_torch.checkpoint import random_state_dict
    from multi_view_stereonet_tpu_torch.data.loader import collate
    from multi_view_stereonet_tpu_torch.models import MultiViewStereoNet
    from multi_view_stereonet_tpu_torch.ops.cuda import refiner as refiner_op
    from multi_view_stereonet_tpu_torch.train import train_cli
    from multi_view_stereonet_tpu_torch.train.config import load_params_yaml
    from multi_view_stereonet_tpu_torch.train.step import make_loss_fn

    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = load_params_yaml(None)
    cfg.update({"num_workers": 0, "debug_image_freq": 0, "plot_freq": 0})
    if two_view:
        cfg.update({"estimate_right_idepthmap": True, **chip_smoke.TWO_VIEW_FACTORS})
    with tempfile.TemporaryDirectory() as tmp:
        data_dir, split = chip_smoke.synthetic_data().make_gta_sfm_tree(
            os.path.join(tmp, "tree"), num_sequences=1, frames=cfg["batch_size"] + 1,
            rows=cfg["size"][0], cols=cfg["size"][1], seed=3, comparisons=1)
        dataset = train_cli.make_dataset(cfg, data_dir, split, True, 0,
                                         np.random.default_rng(0))
        batch = collate([dataset[i] for i in range(cfg["batch_size"])])
    batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()
             if not k.endswith("filenames")}
    if two_view:
        batch = train_cli.two_view_batch(batch)
    model = MultiViewStereoNet()
    model.load_state_dict(random_state_dict(0))
    model = model.to(dev)
    config, loss_config, _, step = train_cli.build_train_step(cfg, 12, model, "auto")
    loss, _ = make_loss_fn(config, loss_config, multi_view=not two_view,
                           estimate_right_idepthmap=two_view, impl="auto")(model, batch)
    loss.backward()
    grad_file = os.path.join(tree, "_train_step_grads.pt")
    torch.save({k: p.grad.detach().cpu() for k, p in model.named_parameters()}, grad_file)
    first_loss = loss.item()
    model.zero_grad(set_to_none=True)
    for _ in range(2):
        step(model, batch)
    torch.cuda.synchronize()
    forward0 = refiner_op.launches
    backward0 = getattr(refiner_op, "backward_launches", None)
    step(model, batch)
    torch.cuda.synchronize()
    launches = {"refiner_forward": refiner_op.launches - forward0,
                "refiner_backward": (None if backward0 is None
                                     else refiner_op.backward_launches - backward0)}
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss, _ = step(model, batch)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        if not np.isfinite(loss.item()):
            raise AssertionError("a non-finite loss")
    peak = torch.cuda.max_memory_allocated()
    busy, wall, prof = chip_smoke.profile_kernels(lambda: step(model, batch), 1)
    return {"ms": statistics.median(times), "times": times, "peak_gib": peak / 2**30,
            "busy_ms": busy, "wall_ms": wall, **chip_smoke.group_norm_device_ms(prof),
            **launches, "loss": first_loss, "grad_file": grad_file}


def train_step_report(runs: list, card: str) -> dict:
    """Print each ``--train-step`` run and the medians; returns the medians."""
    for r in runs:
        print(f"{r['label']}: {r['ms']:.3f} ms a step, peak {r['peak_gib']:.3f} GiB, device "
              f"busy {r['busy_ms']:.3f} ms, native_group_norm {r['native_group_norm_calls']} "
              f"calls {r['native_group_norm_ms']:.3f} ms (backward "
              f"{r['native_group_norm_backward_ms']:.3f}), K3 launches forward "
              f"{r['refiner_forward']} backward {r['refiner_backward']}", flush=True)
    medians = {label: {k: statistics.median(r[k] for r in runs if r["label"] == label)
                       for k in ("ms", "peak_gib", "busy_ms", "native_group_norm_calls")}
               for label in ("parent", "change")}
    print(f"medians ({card}): {json.dumps(medians)}", flush=True)
    return medians


def gradient_agreement(runs: list) -> dict:
    """The first change run's loss and gradients of one step against the first parent
    run's: the loss's relative gap and the worst parameter's max|diff| over max|parent| (a
    gradient below 1e-4 of the largest held to that floor), beside chip_smoke.py's bars."""
    import torch

    first = {label: next(r for r in runs if r["label"] == label) for label in ("parent",
                                                                              "change")}
    ref, got = (torch.load(first[label]["grad_file"]) for label in ("parent", "change"))
    floor = 1e-4 * max(r.abs().max().item() for r in ref.values())
    worst = max((got[k] - r).abs().max().item() / max(r.abs().max().item(), floor)
                for k, r in ref.items())
    loss_gap = abs(first["change"]["loss"] - first["parent"]["loss"]) / abs(
        first["parent"]["loss"])
    result = {"loss_gap": loss_gap, "worst_gradient": worst, "loss_bar": 1e-5,
              "gradient_bar": 2.5e-3}
    print(f"one step from the seeded weights, change against parent: loss "
          f"{first['change']['loss']:.7f} vs {first['parent']['loss']:.7f} ({loss_gap:.2e} "
          f"relative, bar 1e-05); worst gradient {worst:.3e} of max|parent| (bar 2.5e-03)",
          flush=True)
    return result


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("parent")
    parser.add_argument("change")
    parser.add_argument("--pairs", type=int, default=6)
    parser.add_argument("--out", help="write every run and profile here as JSON")
    parser.add_argument("--train-step", action="store_true",
                        help="time the recipe's train step instead (see above)")
    parser.add_argument("--backward", action="store_true",
                        help="time K1's, K2's and K3's backwards instead (see above)")
    parser.add_argument("--two-view", action="store_true",
                        help="with --train-step, the two-view recipe's step (phase 8's)")
    parser.add_argument("--k1-only", action="store_true",
                        help="with --backward, time K1's backward alone")
    parser.add_argument("--child", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child:
        tree = os.path.abspath(args.child)
        run = (measure_train_step(tree, args.two_view) if args.train_step
               else measure_backward(tree, args.k1_only) if args.backward else measure(tree))
        print(json.dumps(run), flush=True)
        return

    trees = {"parent": os.path.abspath(args.parent), "change": os.path.abspath(args.change)}
    order = (["parent", "change", "change", "parent"] * args.pairs)[:2 * args.pairs]
    runs = []
    for label in order:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), args.parent,
                               args.change, "--child", trees[label]]
                              + ["--train-step"] * args.train_step
                              + ["--backward"] * args.backward
                              + ["--k1-only"] * args.k1_only
                              + ["--two-view"] * args.two_view, capture_output=True,
                              text=True, check=True, cwd=trees[label])
        run = {"label": label, **json.loads(proc.stdout.strip().splitlines()[-1])}
        runs.append(run)
        if args.backward:
            keys = [key for key in run if key not in ("label", "tree")]
            print(f"{label}: " + ", ".join(f"{key} {run[key]:.4f}" for key in keys),
                  flush=True)
        if args.train_step or args.backward:
            continue
        k3 = ", ".join(f"{key[3:]} {run[key]:.4f}" for key in K3_KEYS)
        print(f"{label}: {run['ms_per_frame']:.3f} ms/frame, K2 device "
              f"{run['k2_device_ms_n1']:.4f} ms at N=1, {run['k2_device_ms_n5']:.4f} at N=5; "
              f"K3 {k3}", flush=True)
    if args.backward:
        card = smi()
        medians = {label: {key: statistics.median(r[key] for r in runs if r["label"] == label)
                           for key in keys} for label in trees}
        print(f"medians ({card}): {json.dumps(medians)}", flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump({"card": card, "runs": runs, "medians": medians}, f, indent=1)
        return
    if args.train_step:
        card = smi()
        medians = train_step_report(runs, card)
        medians["agreement"] = gradient_agreement(runs)
        if args.out:
            with open(args.out, "w") as f:
                json.dump({"card": card, "runs": runs, "medians": medians}, f, indent=1)
        return
    summary = {}
    for label in trees:
        mine = [r for r in runs if r["label"] == label]
        summary[label] = {key: statistics.median(r[key] for r in mine)
                          for key in ("ms_per_frame", "k2_device_ms_n1", "k2_device_ms_n5",
                                      *K3_KEYS)}
        print(f"{label} medians: {summary[label]}", flush=True)
    digests = {label: {r["output_sha256"] for r in runs if r["label"] == label}
               for label in trees}
    print(f"serving outputs by tree (SHA-256): {digests}; bit-equal across runs and trees "
          f"{len(set().union(*digests.values())) == 1}", flush=True)

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

#!/usr/bin/env python3
"""Drive the PyTorch port (multi_view_stereonet_tpu_torch) on one NVIDIA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each printing its results; any failure raises and exits non-zero:

1. Device: a CUDA card is required. Prints ``nvidia-smi`` name and power
   limit, and the torch and CUDA versions.
2. Build: compiles the four hand-written kernels from ``csrc/``, one nvcc
   each, all started together.
3. Kernels vs their plain PyTorch versions on the card, TF32 off, at the
   serving path's shapes: the grid sample (480x640 min-idepth warp, and
   the 5-view level-4 plane sweep) within 1e-5 abs; the incremental chain
   (N = 1, 5 and 8, 30x40x32, D = 12) and the idepthmap refiner ((N, 35, h,
   w) = (N, 35, 30, 40) for N = 1, 2, 5, 8, and (1, 35, 60, 80)) within atol
   2e-5 * max|plain|, rtol 2e-4; the GroupNorm kernel at every GroupNorm
   shape of the forward (``GN_SHAPES``: resblock tails with the residual,
   bn0 and the 5-D cost filter without) within 1e-5 * max(1, max|plain|).
   For each: a call's median ms over 20 timed runs after warm-up (CUDA
   events, host work included), and the device time alone (``graph_ms``:
   20 calls replayed from a CUDA graph), of kernel and plain version; the
   bound (the larger of the bytes read and written over 3.35 TB/s and the
   f32 operations over 67 TFLOP/s); for the grid sample also
   ``F.grid_sample``'s device time on the same data; for the chain the
   device time with 16- and with 8-block clusters forced. K1 also at the
   two-view losses' shapes, (8, 480, 640, 1) and (8, 480, 640, 3) sampled at a
   grid from ``project_idepthmap``, and at a grid holding NaN and +-inf: NaN
   outputs exactly where the plain version has them, equal flags, all else
   bit-equal.
4. Serving: a synthetic 480x640 GTA-SfM tree, a params.yaml (D = 12, cost
   filter on, five refiners) and seeded fan-in-scale weights saved as
   stereo_network.pth are served through StreamingRunner: four requests at
   B = 1, V = 1, then two at V = 2. Outputs must be finite, (B, 480, 640),
   and within 0.2% of the output range of the same batches served with
   impl="plain" on the card. The launch counters, zeroed just before the
   run, must show per forward two grid-sample launches, one chain, two
   refiner (levels 4 and 3) and 31 GroupNorm launches (the extractor's six
   resblocks, six resblocks and bn0 for each of refiners 2, 1 and 0, and
   the cost filter's four), and none on the plain path. Prints ms per
   frame of kernel and plain paths (B = 1, V = 1).
5. Eval: ``run_eval`` (the eval CLI) on the card, kernel and plain paths,
   over the V = 1 tree at batch 2 (four requests) and a 480x640 DeMoN tree
   (plane depth 4.0, one scene of each of two types, three frames each) at
   batch 1. Every output file is written, the loss is
   finite, the launch counters match each forward's B*V (warm-ups
   included), and every row of the kernel run is within the CPU tests'
   bars of the plain run's (a1-a3 1e-3 absolute, the other columns 1e-4
   relative, NaN equal to NaN). Then the kernel path over a LONG-request
   V = 1 tree at batch 1 and 2: median and mean runtime_ms per image.
6. Transport: all 256 uint8 values dequantized on the card bit-equal to the
   host pipeline; the V = 1 tree served at B = 1 and 4 from a uint8 dataset
   bit-equal to the float32 one, and with a float16 fetch equal to the
   float32 output cast; launches checked. Then depthmaps/s with the
   readback over the LONG-request tree, one runner a run, in turns f32 and
   u8 with four decode threads and f32 with one, twice: the median time
   between consecutive results in the steady window (start-up and drain left
   out) as ms a request, and the window's depthmaps/s.
3b. Backward of each kernel (its ``torch.autograd.Function``, which recomputes
   the plain version) at phase 3's shapes against plain autograd on the card:
   every input's gradient within 1e-4 of max|plain| (a gradient below 1e-4 of
   the largest held to that floor), no launch in the backward; the device time
   of one backward (torch.profiler, the sum of its kernels), of the plain
   path's backward and, for K1 and K4, of ``F.grid_sample``'s and of
   ``F.group_norm`` + ``F.leaky_relu``'s. K1 also at the losses' shapes with image
   and grid both leaves.
7. Training at full width (the reference recipe: B = 8, V = 1, 480x640, D = 12,
   filter and five refiners on, adam 1e-3, augmentation on, 4 loader workers)
   through ``train_cli.train`` over the 96-request tree: 10 steps, validation
   over 16 images and an epoch checkpoint; a second call resumes it for 2
   steps (step count continued) and ``run_eval`` scores its checkpoint. Every
   loss finite; launches 2 / 1 / 2 / 31 a forward (train steps and validation
   batches), none from the backward; the CLI loop's ms a step (host clock
   between steps, loader included) and the loader's ms a batch alone. Then from
   one batch and the same seeded fan-in-scale weights, TF32 off: the kernel
   path's loss within 1e-5 relative of the plain path's and every gradient
   within docs/PARITY.md:218-232's bar; ms a train step (CUDA events, median
   after 2 warm-up steps, kernel and plain path in turns), images/s, peak
   memory (``max_memory_allocated``), the host and device time of the K3
   weight repack that each optimizer step causes, and on each path the device
   time of the forward alone and of one whole step (torch.profiler), with the
   top device operations of a kernel-path step.
8. The two-view recipe at full width (B = 8, 480x640, D = 12, filter and five
   refiners on, adam 1e-3, augmentation on; estimate_right_idepthmap with
   supervision / reconstruction / left-right factors 1.0 / 0.5 / 0.5, the JAX
   package's all-loss case): ``train_cli.train`` over the 96-request tree for 4
   steps, no validation (the JAX CLI's cannot run those losses), resumed for 1;
   losses.txt finite with the reconstruction and left-right columns; launches
   a step derived from the code (two forwards, and K1 12 + 20 + 10 times in the
   occlusion masks, left-right and reconstruction losses), none from the
   backward. Then one batch, kernel path against plain: the loss within 1e-5
   relative and every gradient within phase 7's bar; ms a step (median of 6,
   CUDA events, the paths in turns after 2 warm-up steps each), peak memory, and
   a profile of one kernel-path step (device busy, the forward's device time, the
   top device operations).

9. Weights and the serving artifact: the phase-4 weights written again as a
   TorchScript archive with the reference's names (``tests/reference_archive.py``:
   the right extractor's shared copies, one strided parameter); ``run_eval`` from
   that ``stereo_network.pt`` writes the metric files of the ``.pth`` run, byte for
   byte (runtime files aside). The export CLI, from the ``.pt`` directory, writes
   the eval config's artifact (B = 1, V = 1, 480x640, D = 12, f32) and the
   production contract's (``--batch 24 --u8 --fetch float16``). Each is loaded in a
   fresh process (no weights, the network's modules not imported) and run once on
   the inputs the live ``StreamingRunner`` served: bit-equal outputs (f16 as bits),
   launches 2 / 1 / 2 / 31 at B = 1 and 2 / 1 / 0 / 45 at B = 24 (K3 takes
   n <= 8), the four custom ops in the graph (three at B = 24). Then the
   artifact's ms/frame against the live forward's, median of 20 after warm-up,
   in turns artifact, live, live, artifact; each custom op's host time a call
   against its launch code's called directly, as the eager forward does (the
   dispatcher's cost, which the artifact pays).

Every time and rate printed names the card and its power limit. Before the
last line it prints one JSON line with the kernels' names,
sources, launches, errors, times ("ms" and "plain_ms" are device times of
one call, "call_ms" and "plain_call_ms" a call's time with its host work),
bounds and library times (launches are phase 4's, "train_launches" phase
7's first ``train`` call's, "two_view_launches" one phase-8 step's,
"artifact_launches" and "artifact_launches_b24" phase 9's artifacts' in their
fresh processes; "op_call_us" and "direct_call_us" phase 9's dispatch costs), each
with a "backward" entry (phase 3b); K1's entry and its backward carry "loss_shapes",
one entry each for one and three channels at the losses' shapes. Then the
nvidia-smi line; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
WARP_BAR = 1e-5
BACKWARD_BAR = 1e-4  # times max(max|plain grad|, 1e-4 of the largest), phase 3b
# Training against the plain path (docs/PARITY.md:218-232): per parameter, max|diff|
# within 2.5e-3 of max|plain| and cosine > 0.999998; a leaf below 1e-4 of the
# largest held to that floor; the loss within 1e-5 relative.
GRAD_BAR, COS_BAR, GRAD_FLOOR, LOSS_BAR = 2.5e-3, 1 - 2e-6, 1e-4, 1e-5
TRAIN_B, TRAIN_STEPS, RESUME_STEPS, VAL_IMAGES = 8, 10, 2, 16
# Phase 8: the JAX package's all-loss case (tests/test_grad_parity.py:110-112).
TWO_VIEW_FACTORS = {"supervision_factor": 1.0, "reconstruction_factor": 0.5,
                    "left_right_factor": 0.5}
TWO_VIEW_STEPS, TWO_VIEW_RESUME = 4, 1
NUM_LEVELS = 5
CHAIN_ATOL, CHAIN_RTOL = 2e-5, 2e-4  # also the idepthmap refiner's bar
GN_BAR = 1e-5  # times max(1, max|plain|)
SERVE_BAR = 2e-3  # fraction of the plain path's output range
# Eval rows, kernel path against plain path (tests/test_torch_eval.py's bars).
EVAL_REL_BAR, EVAL_DELTA_BAR = 1e-4, 1e-3
RATIOS = ("a1", "a2", "a3")
# The bound's peaks: NVIDIA H100 SXM data sheet, HBM3 rate and f32 outside the tensor
# cores (dense), at the full 700 W power limit.
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
H0, W0, D = 480, 640, 12
LONG = 96  # requests of the tree that phases 5 and 6 time
ARTIFACT_KEYS = ("left_image", "right_images", "K", "T_right_in_left")
# K4's shapes in the serving forward at B = 1, V = 1 (the filter also at V = 5).
GN_SHAPES = (((2, 32, 30, 40), True, "extractor resblocks, N = B + B*V"),
             ((1, 32, 120, 160), True, "refiner 2 resblocks"),
             ((1, 32, 240, 320), True, "refiner 1 resblocks"),
             ((1, 32, H0, W0), True, "refiner 0 resblocks"),
             ((1, 32, H0, W0), False, "refiner 0 bn0"),
             ((1, 32, D, 30, 40), False, "cost filter, N = B*V = 1"),
             ((5, 32, D, 30, 40), False, "cost filter, N = B*V = 5"))


def log(*args):
    print(*args, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout
    return out.strip().splitlines()[0]


def median_ms(fn, runs=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, reps=20) -> float:
    """Device time of one call: ``reps`` calls captured in a CUDA graph, median of 7
    replays, divided by reps (no host work in the timed span)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return median_ms(graph.replay, runs=7, warmup=1) / reps


def device_ms(fn, reps=5, warmup=2) -> float:
    """Device time of one call: the card's kernel times summed over ``reps`` calls under
    torch.profiler, over reps (the gaps between kernels left out)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e3 / reps


def worst_relative(got, ref):
    """max over tensors of max|got - ref| / max(max|ref|, floor), the floor 1e-4 of the
    largest max|ref|."""
    floor = GRAD_FLOOR * max(r.abs().max().item() for r in ref)
    return max((g - r).abs().max().item() / max(r.abs().max().item(), floor)
               for g, r in zip(got, ref))


def scene(n, seed):
    """n left cameras (K at 480x640) and right poses like the GTA-SfM frames'."""
    rng = np.random.default_rng(seed)
    K = np.eye(4, dtype=np.float32)
    K[0, 0] = K[1, 1] = 0.9 * W0
    K[0, 2], K[1, 2] = (W0 - 1) / 2.0, (H0 - 1) / 2.0
    Ts = []
    for _ in range(n):
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        angle = rng.uniform(-0.05, 0.05)
        S = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                      [-axis[1], axis[0], 0]])
        T = np.eye(4)
        T[:3, :3] = np.eye(3) + np.sin(angle) * S + (1 - np.cos(angle)) * (S @ S)
        T[:3, 3] = [rng.uniform(0.3, 0.5), rng.uniform(-0.05, 0.05), rng.uniform(-0.05, 0.05)]
        Ts.append(T)
    return (torch.from_numpy(np.repeat(K[None], n, 0)).cuda(),
            torch.from_numpy(np.stack(Ts).astype(np.float32)).cuda())


def loss_grid(n, dev, g):
    """The sampling grid of the two-view losses at 480x640: a tilted-plane idepth map per
    sample (0.1-0.5, 1/m at a unit baseline) projected into the right camera by
    ``project_idepthmap`` (n, 480, 640, 2); a share of it falls outside the image."""
    from multi_view_stereonet_tpu_torch.geometry import normalize_baseline, project_idepthmap

    K, T = scene(n, 20 + n)
    T, _ = normalize_baseline(T)
    y = torch.linspace(0, 1, H0)[:, None]
    x = torch.linspace(0, 1, W0)[None, :]
    a, b, c = (torch.rand(3, n, 1, 1, generator=g) * 0.2).unbind(0)
    idepth = 0.1 + a + b * x + c * y
    return project_idepthmap(K, T, idepth.to(dev))[0]


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(read_write_bytes, flops):
    """The least time (ms) the card could take: bytes over its memory rate or f32
    operations over its peak, the larger, and which of the two it is."""
    by_bytes = read_write_bytes / PEAK_BYTES_S * 1e3
    by_ops = flops / PEAK_F32_FLOPS * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def conv_flops(module, pixels) -> int:
    """2 x multiply-adds of every 3x3 conv of ``module`` over ``pixels`` outputs each."""
    return 2 * pixels * sum(m.weight.numel() for m in module.modules()
                            if isinstance(m, torch.nn.Conv2d))


def timings(kernel, plain):
    """A call (wrapper, host work included) and the device time alone, of kernel and
    plain version."""
    return {"call_ms": median_ms(kernel), "plain_call_ms": median_ms(plain),
            "ms": graph_ms(kernel), "plain_ms": graph_ms(plain)}


def describe(t, b):
    return (f"a call: kernel {t['call_ms']:.4f} ms, plain {t['plain_call_ms']:.4f} ms; "
            f"device: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms; bound "
            f"{b[0]:.4f} ms ({b[1]})")


def check_kernels(dev):
    """Phase 3: each kernel against its plain version at the serving shapes, its time
    on the device beside its bound, and (K1) the one PyTorch call that computes it."""
    import torch.nn.functional as F

    from multi_view_stereonet_tpu_torch.checkpoint import random_state_dict
    from multi_view_stereonet_tpu_torch.geometry import (
        build_K_pyramid, create_idepth_samples, create_plane_sweep_homographies,
        incremental_homographies, normalize_baseline)
    from multi_view_stereonet_tpu_torch.models import FeatureRefiner, IDepthmapRefiner
    from multi_view_stereonet_tpu_torch.ops import homography_grid
    from multi_view_stereonet_tpu_torch.ops.cuda import gn_apply
    from multi_view_stereonet_tpu_torch.ops.cuda import incremental_chain as chain
    from multi_view_stereonet_tpu_torch.ops.cuda import refiner as refiner_op
    from multi_view_stereonet_tpu_torch.ops.cuda import warp
    from multi_view_stereonet_tpu_torch.train.pipeline import pyramid_sizes

    g = torch.Generator().manual_seed(0)
    results = {}

    def geometry(n, seed):
        K, T = scene(n, seed)
        T, _ = normalize_baseline(T)
        K_pyr = build_K_pyramid(K, pyramid_sizes(H0, W0, 5))
        samples = create_idepth_samples(T, K_pyr[4], 30, 40, D)
        return K_pyr, T, samples

    def check_warp(image, grid, what, zero=True):
        """K1 vs plain; F.grid_sample on the same data, the NCHW copy made outside the
        timed span, is the one PyTorch call for the same function (less the mask)."""
        got, inv = warp.grid_sample(image, grid, zero_invalid=zero, impl="kernel")
        ref, inv_ref = warp.grid_sample(image, grid, zero_invalid=zero, impl="plain")
        err = (got - ref).abs().max().item()
        t = timings(lambda: warp.grid_sample(image, grid, zero, impl="kernel"),
                    lambda: warp.grid_sample(image, grid, zero, impl="plain"))
        x_nchw = image.permute(0, 3, 1, 2).contiguous()
        grid4 = grid.reshape(grid.shape[0], -1, grid.shape[-2], 2)
        t["library_ms"] = graph_ms(lambda: F.grid_sample(
            x_nchw, grid4, mode="bilinear", padding_mode="border", align_corners=False))
        pixels = got.numel() // image.shape[-1]
        b = bound(nbytes(image, grid, got, inv), pixels * (20 + 7 * image.shape[-1]))
        log(f"K1 grid_sample {what}: max_abs_err {err:.3e} (bar {WARP_BAR:.0e}), invalid "
            f"masks equal {bool(torch.equal(inv, inv_ref))}, invalid share "
            f"{inv.float().mean().item():.4f}; {describe(t, b)}; F.grid_sample device "
            f"{t['library_ms']:.4f} ms")
        if not (err <= WARP_BAR and torch.equal(inv, inv_ref)):
            raise AssertionError(f"K1 disagrees with its plain version at {what}")
        return err, t, b

    # K1 at the min-idepth warp, (1, 480, 640, 3), and at the plane sweep,
    # (5, 30, 40, 3) -> (5, 12, 30, 40, 3); the JSON line keeps the first's times.
    K_pyr, T, samples = geometry(1, 1)
    H_min = create_plane_sweep_homographies(T, K_pyr[0], samples[:, :1])[:, 0]
    image = (torch.rand(1, H0, W0, 3, generator=g) * 2 - 1).to(dev)
    err, t, b = check_warp(image, homography_grid(H_min, H0, W0),
                           "(1,480,640,3) min-idepth warp")
    results["warp"] = {"max_abs_err": err, **t, "bound_ms": b[0], "bound_by": b[1]}
    K_pyr, T, samples = geometry(5, 2)
    grid = homography_grid(create_plane_sweep_homographies(T, K_pyr[4], samples), 30, 40)
    image4 = (torch.rand(5, 30, 40, 3, generator=g) * 2 - 1).to(dev)
    err, _, _ = check_warp(image4, grid, "(5,30,40,3)->(5,12,30,40,3) plane sweep")
    results["warp"]["max_abs_err"] = max(results["warp"]["max_abs_err"], err)

    # K1 where the two-view losses call it (phase 8): the grid projected from a B = 8
    # 480x640 idepth map, sampling one channel (idepth maps, occlusion masks) and three
    # (the reconstruction's right image). Each shape's times go into "loss_shapes".
    grid = loss_grid(TRAIN_B, dev, g)
    results["warp"]["loss_shapes"] = []
    for C, what in ((1, "idepth and occlusion samples"), (3, "reconstruction")):
        image = (torch.rand(TRAIN_B, H0, W0, C, generator=g) * 2 - 1).to(dev)
        err, t, b = check_warp(image, grid, f"({TRAIN_B},{H0},{W0},{C}) {what}", zero=False)
        results["warp"]["loss_shapes"].append({"shape": [TRAIN_B, H0, W0, C],
                                               "max_abs_err": err, **t, "bound_ms": b[0],
                                               "bound_by": b[1]})
        results["warp"]["max_abs_err"] = max(results["warp"]["max_abs_err"], err)

    # A NaN coordinate gives NaN in every channel where the plain version does (and
    # the JAX gather), +-inf clamps to the border; the flags and all else agree bit for bit.
    bad = grid.clone()
    bad[0, :4, :8, 0] = float("nan")
    bad[1, 5, :8, 1] = float("nan")
    bad[2, 7, :4] = float("nan")
    bad[3, 9, :4, 0], bad[3, 9, 4:8, 1] = float("inf"), -float("inf")
    bad[4, 11, :4, 0], bad[4, 11, :4, 1] = float("nan"), 5.0
    for C in (1, 3):
        image = (torch.rand(TRAIN_B, H0, W0, C, generator=g) * 2 - 1).to(dev)
        for zero_invalid in (False, True):
            got, inv = warp.grid_sample(image, bad, zero_invalid, impl="kernel")
            ref, inv_ref = warp.grid_sample(image, bad, zero_invalid, impl="plain")
            nan_equal = torch.equal(torch.isnan(got), torch.isnan(ref))
            rest_equal = torch.equal(torch.nan_to_num(got, nan=7.0),
                                     torch.nan_to_num(ref, nan=7.0))
            log(f"K1 NaN grid C={C} zero_invalid={zero_invalid}: NaN outputs "
                f"{int(torch.isnan(got).sum())} (plain {int(torch.isnan(ref).sum())}), "
                f"at the same places {nan_equal}; invalid flags equal "
                f"{torch.equal(inv, inv_ref)}; all else bit-equal {rest_equal}")
            if not (nan_equal and rest_equal and torch.equal(inv, inv_ref)
                    and bool(torch.isnan(ref).any())):
                raise AssertionError("K1 disagrees with its plain version at a NaN grid")

    # K2 at N = B*V = 1, 5 and 8, 30x40x32, D = 12, seeded fan-in-scale refiner; the
    # device time also with each cluster size forced. The JSON line keeps N = 1.
    refiner = FeatureRefiner(32)
    prefix = "right_feature_extractor.refiner."
    refiner.load_state_dict({k[len(prefix):]: v for k, v in random_state_dict(3).items()
                             if k.startswith(prefix)})
    refiner = refiner.to(dev).eval()
    for n in (1, 5, 8):
        K_pyr, T, samples = geometry(n, 10 + n)
        H_inc = incremental_homographies(
            create_plane_sweep_homographies(T, K_pyr[4], samples))
        feats0 = torch.randn(n, 30, 40, 32, generator=g).to(dev)
        image_rest = (torch.rand(n, D - 1, 30, 40, 3, generator=g) * 2 - 1).to(dev)

        def kernel(cluster=0):
            return chain.incremental_chain_kernel(refiner, feats0, image_rest, H_inc, cluster)

        def plain():
            return chain.incremental_chain(refiner, feats0, image_rest, H_inc, impl="plain")
        got, ref = kernel(), plain()
        scale = ref.abs().max().item()
        err = (got - ref).abs().max().item()
        ok = bool(torch.isfinite(got).all()) and torch.allclose(
            got, ref, atol=CHAIN_ATOL * scale, rtol=CHAIN_RTOL)
        t = timings(kernel, plain) if n == 1 else {"ms": graph_ms(kernel)}
        forced = {c: graph_ms(lambda: kernel(c)) for c in (16, 8)}
        b = bound(nbytes(feats0, image_rest, H_inc, got, *refiner.parameters()),
                  (D - 1) * (conv_flops(refiner, n * 30 * 40) + 20 * got[:, 0].numel()))
        detail = describe(t, b) if n == 1 else f"device {t['ms']:.4f} ms, bound {b[0]:.4f} ms ({b[1]})"
        log(f"K2 incremental_chain N={n} 30x40x32 D={D}: max_abs_err {err:.3e}, max|plain| "
            f"{scale:.3f} (bar atol {CHAIN_ATOL:.0e}*max|plain| + rtol {CHAIN_RTOL:.0e}), "
            f"within bar {ok}; cluster {chain.cluster_size(n, 30, 40)} blocks a sample; "
            f"{detail}; device with 16-block clusters {forced[16]:.4f} ms, with 8 "
            f"{forced[8]:.4f} ms")
        if not ok:
            raise AssertionError(f"K2 disagrees with its plain version at N={n}")
        if n == 1:
            results["chain"] = {"max_abs_err": err, **t, "bound_ms": b[0], "bound_by": b[1],
                                "library_ms": None}
        else:
            results["chain"]["max_abs_err"] = max(results["chain"]["max_abs_err"], err)

    # K3 at the refiners of level 4 (N = B*V = 1, 2, 5 and 8: the B=1 V=1, V=2, V=5 and
    # B=8 cells) and level 3 (N = 1); the JSON line keeps the level-3 times, where it
    # does the most work.
    state = random_state_dict(4)
    results["refiner"] = {"max_abs_err": 0.0, "library_ms": None}
    for n, h, w, name in ((1, 30, 40, "refiner4"), (2, 30, 40, "refiner4"),
                          (5, 30, 40, "refiner4"), (8, 30, 40, "refiner4"),
                          (1, 60, 80, "refiner3")):
        with torch.inference_mode(False):  # parameters with version counters, as served
            module = IDepthmapRefiner(35)
            module.load_state_dict({k[len(name) + 1:]: v for k, v in state.items()
                                    if k.startswith(name + ".")})
            module = module.to(dev).eval()
        guidance = (torch.rand(n, 35, h, w, generator=g) * 2 - 1).to(dev)
        idepth = (torch.rand(n, h, w, generator=g) * 20).to(dev)
        got = refiner_op.idepthmap_refiner(module, guidance, idepth, impl="kernel")
        ref = refiner_op.idepthmap_refiner(module, guidance, idepth, impl="plain")
        scale = ref.abs().max().item()
        err = (got - ref).abs().max().item()
        ok = bool(torch.isfinite(got).all()) and torch.allclose(
            got, ref, atol=CHAIN_ATOL * scale, rtol=CHAIN_RTOL)
        t = timings(lambda: refiner_op.idepthmap_refiner(module, guidance, idepth,
                                                         impl="kernel"),
                    lambda: refiner_op.idepthmap_refiner(module, guidance, idepth,
                                                         impl="plain"))
        b = bound(nbytes(guidance, idepth, got, *module.parameters()),
                  conv_flops(module, n * h * w) + 7 * 10 * 32 * n * h * w)
        log(f"K3 idepthmap_refiner ({n},35,{h},{w}): max_abs_err {err:.3e}, max|plain| "
            f"{scale:.3f} (bar atol {CHAIN_ATOL:.0e}*max|plain| + rtol {CHAIN_RTOL:.0e}), "
            f"within bar {ok}; {describe(t, b)}")
        if not ok:
            raise AssertionError(f"K3 disagrees with its plain version at ({n},35,{h},{w})")
        results["refiner"].update(max_abs_err=max(results["refiner"]["max_abs_err"], err),
                                  **t, bound_ms=b[0], bound_by=b[1])

    # K4 at every GroupNorm shape of the serving forward, held against the plain
    # version; the JSON line keeps the 480x640 resblock's times.
    weight = state["refiner0.res0.bn1.weight"].to(dev)
    bias = state["refiner0.res0.bn1.bias"].to(dev)
    results["gn_apply"] = {"max_abs_err": 0.0, "library_ms": None}
    for shape, residual, what in GN_SHAPES:
        x = (torch.randn(shape, generator=g) * 2 + 0.5).to(dev)
        res = torch.randn(shape, generator=g).to(dev) if residual else None

        def kernel():
            return gn_apply.group_norm_act(x, weight, bias, 4, res, impl="kernel")

        def plain():
            return gn_apply.group_norm_act(x, weight, bias, 4, res, impl="plain")
        got, ref = kernel(), plain()
        tol = GN_BAR * max(1.0, ref.abs().max().item())
        err = (got - ref).abs().max().item()
        t = timings(kernel, plain)
        b = bound(nbytes(x, got, weight, bias, *([res] if residual else [])), 10 * x.numel())
        log(f"K4 group_norm_act {shape} {'+ res' if residual else 'no res'} ({what}): "
            f"max_abs_err {err:.3e} (bar {tol:.3e}); {describe(t, b)}")
        if not (err <= tol and bool(torch.isfinite(got).all())):
            raise AssertionError(f"K4 disagrees with its plain version at {shape}")
        results["gn_apply"]["max_abs_err"] = max(results["gn_apply"]["max_abs_err"], err)
        if shape == (1, 32, H0, W0) and residual:
            results["gn_apply"].update(**t, bound_ms=b[0], bound_by=b[1])
    return results


def check_backward(dev):
    """Phase 3b: each kernel's backward (the plain version recomputed inside its
    Function) against plain autograd at phase 3's shapes, with its device time, the plain
    path's and (K1, K4) the library's. Returns {kernel: backward entry}."""
    import torch.nn.functional as F

    from multi_view_stereonet_tpu_torch.checkpoint import random_state_dict
    from multi_view_stereonet_tpu_torch.geometry import (
        build_K_pyramid, create_idepth_samples, create_plane_sweep_homographies,
        incremental_homographies, normalize_baseline)
    from multi_view_stereonet_tpu_torch.models import FeatureRefiner, IDepthmapRefiner
    from multi_view_stereonet_tpu_torch.ops import homography_grid
    from multi_view_stereonet_tpu_torch.ops.cuda import gn_apply
    from multi_view_stereonet_tpu_torch.ops.cuda import incremental_chain as chain
    from multi_view_stereonet_tpu_torch.ops.cuda import refiner as refiner_op
    from multi_view_stereonet_tpu_torch.ops.cuda import warp
    from multi_view_stereonet_tpu_torch.train.pipeline import pyramid_sizes

    g = torch.Generator().manual_seed(1)
    results = {}

    def geometry(n, seed):
        K, T = scene(n, seed)
        T, _ = normalize_baseline(T)
        K_pyr = build_K_pyramid(K, pyramid_sizes(H0, W0, 5))
        return K_pyr, T, create_idepth_samples(T, K_pyr[4], 30, 40, D)

    def leaf(x):
        return x.to(dev).requires_grad_()

    def check(key, what, run, inputs, library=None, keep=False):
        """run(impl) -> output; library() -> (output, inputs) of the one PyTorch call.
        The JSON line keeps the times of the shape checked with ``keep``."""
        outs = {impl: run(impl) for impl in ("kernel", "plain")}
        cot = torch.randn(outs["plain"].shape, generator=g).to(dev)

        def backward(impl):
            return torch.autograd.grad(outs[impl], inputs, cot, retain_graph=True)
        before = read_launches()
        got, ref = backward("kernel"), backward("plain")
        torch.cuda.synchronize()
        if read_launches() != before:
            raise AssertionError(f"{key} {what}: the backward launched a kernel")
        err = worst_relative(got, ref)
        entry = {"max_rel_err": err, "ms": device_ms(lambda: backward("kernel")),
                 "plain_ms": device_ms(lambda: backward("plain")), "library_ms": None}
        if library is not None:
            lib_out, lib_inputs = library()
            lib_cot = torch.randn(lib_out.shape, generator=g).to(dev)
            entry["library_ms"] = device_ms(lambda: torch.autograd.grad(
                lib_out, lib_inputs, lib_cot, retain_graph=True))
        lib = ("" if entry["library_ms"] is None
                else f", library {entry['library_ms']:.4f} ms")
        log(f"{key} backward {what}: worst gradient error {err:.3e} of max|plain| (bar "
            f"{BACKWARD_BAR:.0e}); device: through the kernel's Function {entry['ms']:.4f} "
            f"ms, plain path {entry['plain_ms']:.4f} ms{lib}")
        if not err <= BACKWARD_BAR:
            raise AssertionError(f"{key} backward disagrees with plain autograd at {what}")
        old = results.get(key)
        if old is not None:
            base = entry if keep else old
            results[key] = {**base, "max_rel_err": max(old["max_rel_err"], err)}
        else:
            results[key] = entry

    # K1 at the min-idepth warp (the JSON keeps its times) and the plane sweep.
    for n, rows, cols, grid_of, what in (
            (1, H0, W0, lambda K_pyr, T, s: homography_grid(
                create_plane_sweep_homographies(T, K_pyr[0], s[:, :1])[:, 0], H0, W0),
             "(1,480,640,3) min-idepth warp"),
            (5, 30, 40, lambda K_pyr, T, s: homography_grid(
                create_plane_sweep_homographies(T, K_pyr[4], s), 30, 40),
             "(5,30,40,3)->(5,12,30,40,3) plane sweep")):
        image = leaf(torch.rand(n, rows, cols, 3, generator=g) * 2 - 1)
        grid = leaf(grid_of(*geometry(n, n)))

        def library(image=image, grid=grid):
            x = image.detach().permute(0, 3, 1, 2).contiguous().requires_grad_()
            grid4 = grid.detach().reshape(n, -1, grid.shape[-2], 2).requires_grad_()
            return F.grid_sample(x, grid4, mode="bilinear", padding_mode="border",
                                 align_corners=False), (x, grid4)
        check("K1", what, lambda impl: warp.grid_sample(image, grid, True, impl)[0],
              (image, grid), library, keep=n == 1)

    # K1 where the two-view losses call it: one channel and three at 480x640, B = 8, the
    # grid projected from idepth; image and grid both leaves.
    grid0 = loss_grid(TRAIN_B, dev, g)
    for C in (1, 3):
        image = leaf(torch.rand(TRAIN_B, H0, W0, C, generator=g) * 2 - 1)
        grid = grid0.detach().clone().requires_grad_()

        def library(image=image, grid=grid):
            x = image.detach().permute(0, 3, 1, 2).contiguous().requires_grad_()
            grid4 = grid.detach().clone().requires_grad_()
            return F.grid_sample(x, grid4, mode="bilinear", padding_mode="border",
                                 align_corners=False), (x, grid4)
        check(f"K1 C={C}", f"({TRAIN_B},{H0},{W0},{C}) loss samples, image and grid leaves",
              lambda impl: warp.grid_sample(image, grid, False, impl)[0], (image, grid),
              library)

    # K2 at N = 1 (the JSON keeps it) and N = 8, the training recipe's B*V.
    refiner = FeatureRefiner(32)
    prefix = "right_feature_extractor.refiner."
    refiner.load_state_dict({k[len(prefix):]: v for k, v in random_state_dict(3).items()
                             if k.startswith(prefix)})
    refiner = refiner.to(dev)
    for n in (1, 8):
        K_pyr, T, samples = geometry(n, 10 + n)
        H_inc = incremental_homographies(create_plane_sweep_homographies(T, K_pyr[4], samples))
        feats0 = leaf(torch.randn(n, 30, 40, 32, generator=g))
        image_rest = (torch.rand(n, D - 1, 30, 40, 3, generator=g) * 2 - 1).to(dev)
        check("K2", f"N={n} 30x40x32 D={D}",
              lambda impl: chain.incremental_chain(refiner, feats0, image_rest, H_inc, impl),
              (feats0, *refiner.parameters()), keep=n == 1)

    # K3 at level 4 (N = 1, 8) and level 3 (N = 1, the JSON keeps it).
    state = random_state_dict(4)
    for n, h, w, name in ((1, 30, 40, "refiner4"), (8, 30, 40, "refiner4"),
                          (1, 60, 80, "refiner3")):
        module = IDepthmapRefiner(35)
        module.load_state_dict({k[len(name) + 1:]: v for k, v in state.items()
                                if k.startswith(name + ".")})
        module = module.to(dev)
        guidance = leaf(torch.rand(n, 35, h, w, generator=g) * 2 - 1)
        idepth = leaf(torch.rand(n, h, w, generator=g) * 20)
        check("K3", f"({n},35,{h},{w})",
              lambda impl: refiner_op.idepthmap_refiner(module, guidance, idepth, impl),
              (guidance, idepth, *module.parameters()), keep=h == 60)

    # K4 at every GroupNorm shape of the serving forward; the JSON keeps the 480x640
    # resblock's times.
    weight = leaf(state["refiner0.res0.bn1.weight"].clone())
    bias = leaf(state["refiner0.res0.bn1.bias"].clone())
    for shape, residual, what in GN_SHAPES:
        x = leaf(torch.randn(shape, generator=g) * 2 + 0.5)
        res = leaf(torch.randn(shape, generator=g)) if residual else None

        def library(x=x, res=res):
            xs = x.detach().requires_grad_()
            rs = None if res is None else res.detach().requires_grad_()
            out = F.leaky_relu(F.group_norm(xs, 4, weight, bias, 1e-5), 0.2)
            return (out if rs is None else out + rs), tuple(t for t in (xs, weight, bias, rs)
                                                           if t is not None)
        check("K4", f"{shape} {'+ res' if residual else 'no res'} ({what})",
              lambda impl: gn_apply.group_norm_act(x, weight, bias, 4, res, impl),
              tuple(t for t in (x, weight, bias, res) if t is not None), library,
              keep=shape == (1, 32, H0, W0) and residual)
    return results


def train_phase(dev, inputs, smi):
    """Phase 7: the training CLI at full width, resumed and evaluated; then one batch
    through the kernel and plain paths: gradients, ms a step, memory, the repack and a
    profile. Returns (train() launches, summary)."""
    from torch.profiler import ProfilerActivity, profile

    from multi_view_stereonet_tpu_torch.checkpoint import native, random_state_dict
    from multi_view_stereonet_tpu_torch.data.loader import collate
    from multi_view_stereonet_tpu_torch.eval.test_cli import run_eval
    from multi_view_stereonet_tpu_torch.models import MultiViewStereoNet
    from multi_view_stereonet_tpu_torch.ops.cuda import refiner as refiner_op
    from multi_view_stereonet_tpu_torch.train import train_cli
    from multi_view_stereonet_tpu_torch.train.config import load_params_yaml
    from multi_view_stereonet_tpu_torch.train.step import make_loss_fn

    data_dir, split = inputs["long"]
    cfg = load_params_yaml(None)  # the recipe: B = 8, 480x640, D = 12, adam 1e-3, augment
    cfg.update({"num_workers": 4, "num_val_images": VAL_IMAGES, "debug_image_freq": 0,
                "plot_freq": 0})
    if (cfg["batch_size"], tuple(cfg["size"]), cfg["num_idepth_samples"]) != (
            TRAIN_B, (H0, W0), D) or not (cfg["augment"] and all(cfg["refiners"])):
        raise AssertionError(f"the recipe's defaults moved: {cfg}")
    out = os.path.join(inputs["root"], "train")
    val_forwards = -(-VAL_IMAGES // TRAIN_B)

    def run(max_steps, num_epochs, forwards):
        """One train() call; its launches, seconds and the host time at the end of each
        step (``stop_check`` runs once a step, after the step is queued)."""
        stamps = []

        def stamp():
            stamps.append(time.perf_counter())
            return False
        zero_launches()
        t0 = time.perf_counter()
        train_cli.train(dict(cfg, num_epochs=num_epochs), data_dir, split, split, out,
                        max_steps=max_steps, stop_check=stamp, device=dev)
        seconds = time.perf_counter() - t0
        launches = read_launches()
        expected = expected_launches([(TRAIN_B, 1)] * forwards)
        if launches != expected:
            raise AssertionError(f"train: expected launches {expected}, got {launches}")
        return launches, seconds, stamps

    launches, seconds, stamps = run(TRAIN_STEPS, 1, TRAIN_STEPS + val_forwards)
    # The loop reads each step's loss after queuing the next, so from the third step on
    # the time between steps is the CLI's rate, loader included.
    gaps = np.diff(stamps)[2:] * 1e3
    cli_ms = float(np.median(gaps))
    log(f"train: {TRAIN_STEPS} steps at B={TRAIN_B} V=1 {H0}x{W0} D={D} and validation over "
        f"{VAL_IMAGES} images in {seconds:.1f} s (loader start-up, first calls and the "
        f"checkpoint included); launches {launches}: per forward {TRAIN_STEPS} steps + "
        f"{val_forwards} validation batches, none from the backward; the CLI loop "
        f"{cli_ms:.3f} ms a step (median of steps 4-{TRAIN_STEPS}, host clock; "
        f"{[round(g, 1) for g in gaps]}), {TRAIN_B * 1e3 / cli_ms:.2f} images/s ({smi})")
    _, resume_seconds, _ = run(TRAIN_STEPS + RESUME_STEPS, 2, RESUME_STEPS + val_forwards)
    with open(os.path.join(out, "losses.txt")) as f:
        rows = [line.split() for line in f.read().splitlines()[1:]]
    steps = [int(r[2]) for r in rows]
    losses = [float(r[3]) for r in rows]
    root = os.path.join(out, "checkpoints")
    if (steps != list(range(1, TRAIN_STEPS + RESUME_STEPS + 1)) or not np.isfinite(losses).all()
            or native.latest_epoch(root) != 1
            or native.load_train_state(root, 1)["step"] != TRAIN_STEPS + RESUME_STEPS):
        raise AssertionError(f"train: steps {steps}, losses {losses}")
    with open(os.path.join(out, "validation.txt")) as f:
        val_rows = f.read().splitlines()
    log(f"train: resumed from epoch 0 for {RESUME_STEPS} steps in {resume_seconds:.1f} s; "
        f"losses by step {[round(x, 3) for x in losses]}, all finite; validation.txt "
        f"{val_rows}")
    data_dir1, split1 = inputs["trees"][1]
    eval_out = os.path.join(inputs["root"], "eval_trained")
    eval_loss, avg = run_eval(os.path.join(root, "epoch0001"), data_dir1, split1, eval_out,
                              batch_size=2, params_file=inputs["params_yaml"],
                              decode_backend="pil", device=dev)
    if not (np.isfinite(eval_loss) and os.path.exists(
            os.path.join(eval_out, "avg_depth_metrics.txt"))):
        raise AssertionError(f"run_eval of the trained checkpoint: loss {eval_loss}")
    log(f"train: run_eval of checkpoints/epoch0001/stereo_network.pth over "
        f"{avg['num_samples']} images: loss {eval_loss:.4f}, abs_rel {avg['abs_rel']:.4f}")

    # The recipe's loader alone (augmentation on, 4 workers), one epoch: whether it keeps
    # up with the step.
    dataset = train_cli.make_dataset(cfg, data_dir, split, True, 0, np.random.default_rng(0))
    loader_stamps = [time.perf_counter() for _ in train_cli.BatchLoader(
        dataset, TRAIN_B, shuffle=True, seed=0, workers=cfg["num_workers"])]
    loader_ms = float(np.median(np.diff(loader_stamps)[1:])) * 1e3
    log(f"train: the loader alone, augmentation on, {cfg['num_workers']} workers: "
        f"{loader_ms:.3f} ms a batch of {TRAIN_B} (median over an epoch of "
        f"{len(loader_stamps)} batches, host clock), {TRAIN_B * 1e3 / loader_ms:.2f} images/s")

    # One batch of the recipe, as the loader gives it, on the card.
    batch = collate([dataset[i] for i in range(TRAIN_B)])
    batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()
             if not k.endswith("filenames")}
    state0 = random_state_dict(0)

    def fresh(impl):
        model = MultiViewStereoNet()
        model.load_state_dict(state0)
        model = model.to(dev)
        config, loss_config, _, step = train_cli.build_train_step(cfg, 12, model, impl)
        return model, config, loss_config, step

    # Gradients, kernel path against plain, from the same weights and batch.
    grads, loss_of = {}, {}
    for impl in ("auto", "plain"):
        model, config, loss_config, _ = fresh(impl)
        zero_launches()
        loss, _ = make_loss_fn(config, loss_config, impl=impl)(model, batch)
        forward = read_launches()
        loss.backward()
        torch.cuda.synchronize()
        expected = (expected_launches([(TRAIN_B, 1)]) if impl == "auto"
                    else dict.fromkeys(forward, 0))
        if not (forward == read_launches() == expected):
            raise AssertionError(f"{impl}: forward launches {forward}, after the backward "
                                 f"{read_launches()}, expected {expected}")
        loss_of[impl] = loss.item()
        grads[impl] = {k: p.grad for k, p in model.named_parameters()}
        if impl == "auto":
            log(f"train step launches: forward {forward}, backward none")
    ref = grads["plain"]
    worst, worst_key, min_cos = compare_gradients(grads)
    loss_gap = abs(loss_of["auto"] - loss_of["plain"]) / abs(loss_of["plain"])
    log(f"train step kernel vs plain (TF32 off, same weights and batch): loss "
        f"{loss_of['auto']:.6f} vs {loss_of['plain']:.6f} ({loss_gap:.2e} relative, bar "
        f"{LOSS_BAR:.0e}); worst gradient {worst:.3e} of max|plain| at {worst_key} (bar "
        f"{GRAD_BAR:.1e}), least cosine {min_cos:.9f} (bar {COS_BAR}), over {len(ref)} "
        f"parameters")
    if not (np.isfinite(loss_of["auto"]) and loss_gap <= LOSS_BAR and worst <= GRAD_BAR
            and min_cos > COS_BAR):
        raise AssertionError("the kernel path's training gradients miss the bar")
    del grads

    # ms a step: kernel and plain paths in turns, two warm-up steps each first.
    steps_by = {impl: fresh(impl) for impl in ("auto", "plain")}
    times, peak = time_steps(steps_by, batch)
    ms = {impl: statistics.median(t) for impl, t in times.items()}
    for impl in ("auto", "plain"):
        log(f"train step {'kernel' if impl == 'auto' else 'plain'} path, B={TRAIN_B} V=1 "
            f"{H0}x{W0} D={D}, adam: {ms[impl]:.3f} ms a step (median of "
            f"{len(times[impl])}, CUDA events; {[round(t, 2) for t in times[impl]]}), "
            f"{TRAIN_B * 1e3 / ms[impl]:.2f} images/s, peak memory "
            f"{peak[impl] / 2**30:.3f} GiB ({smi})")

    # The K3 repack each optimizer step causes (the weights' versions moved).
    module = steps_by["auto"][0].refiner4
    host, dev_ms = [], []
    for _ in range(10):
        with torch.no_grad():
            module.conv0.bias.add_(0.0)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        refiner_op.packed_weights(module)
        end.record()
        host.append((time.perf_counter() - t0) * 1e3)
        end.synchronize()
        dev_ms.append(start.elapsed_time(end))
    repack = {"host_ms": statistics.median(host), "events_ms": statistics.median(dev_ms)}
    log(f"K3 repack after a weight update: host {repack['host_ms']:.3f} ms, CUDA events "
        f"{repack['events_ms']:.3f} ms (median of 10; two fused refiners a step)")

    # Device time of the forward alone and of one whole step on each path (torch.profiler,
    # kernels summed): what the backward and the optimizer step take, and on the kernel
    # path what the recompute adds; the top device operations of one kernel-path step.
    from torch.autograd import DeviceType
    device = {}
    for impl, (model, config, loss_config, step) in steps_by.items():
        loss_fn = make_loss_fn(config, loss_config, impl=impl)
        forward = device_ms(lambda: loss_fn(model, batch), reps=3, warmup=1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(model, batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        busy = sum(e.time_range.elapsed_us() for e in prof.events()
                   if e.device_type == DeviceType.CUDA) / 1e3
        device[impl] = {"forward_ms": forward, "busy_ms": busy, "wall_ms": wall}
        log(f"train step profile ({'kernel' if impl == 'auto' else 'plain'} path, one step): "
            f"device busy {busy:.3f} ms of {wall:.3f} ms wall (profiler on), idle "
            f"{max(0.0, 1 - busy / wall):.1%}; the forward alone {forward:.3f} ms device "
            f"(mean of 3), the backward and the optimizer step {busy - forward:.3f} ms")
        if impl == "auto":
            log(prof.key_averages().table(sort_by="self_device_time_total", row_limit=15))
    after = {impl: d["busy_ms"] - d["forward_ms"] for impl, d in device.items()}
    log(f"train step backward + optimizer step, device: kernel path {after['auto']:.3f} ms, "
        f"plain path {after['plain']:.3f} ms; the kernels' recompute adds "
        f"{after['auto'] - after['plain']:.3f} ms, their forward saves "
        f"{device['plain']['forward_ms'] - device['auto']['forward_ms']:.3f} ms ({smi})")
    summary = {"ms": ms, "images_s": {k: TRAIN_B * 1e3 / v for k, v in ms.items()},
               "cli_ms": cli_ms, "loader_ms": loader_ms,
               "peak_gib": {k: v / 2**30 for k, v in peak.items()}, "repack": repack,
               "device": device, "grad_err": worst, "loss_gap": loss_gap}
    return launches, summary


def two_view_phase(dev, inputs, smi):
    """Phase 8: the two-view recipe with every loss branch at full width, through
    ``train_cli.train`` and resumed; then one batch through the kernel and plain paths:
    launches, the loss and gradients, ms a step and memory. Returns (one step's
    launches, summary)."""
    from multi_view_stereonet_tpu_torch.checkpoint import native, random_state_dict
    from multi_view_stereonet_tpu_torch.data.loader import collate
    from multi_view_stereonet_tpu_torch.models import MultiViewStereoNet
    from multi_view_stereonet_tpu_torch.train import train_cli
    from multi_view_stereonet_tpu_torch.train.config import load_params_yaml
    from multi_view_stereonet_tpu_torch.train.step import make_loss_fn

    data_dir, split = inputs["long"]
    cfg = load_params_yaml(None)  # the recipe: B = 8, 480x640, D = 12, adam 1e-3, augment
    cfg.update({"num_workers": 4, "debug_image_freq": 0, "plot_freq": 0,
                "estimate_right_idepthmap": True, **TWO_VIEW_FACTORS})
    out = os.path.join(inputs["root"], "train_two_view")

    def run(max_steps, num_epochs, steps):
        zero_launches()
        t0 = time.perf_counter()
        train_cli.train(dict(cfg, num_epochs=num_epochs), data_dir, split, "", out,
                        max_steps=max_steps, device=dev)
        seconds = time.perf_counter() - t0
        launches, expected = read_launches(), two_view_launches(steps)
        if launches != expected:
            raise AssertionError(f"two-view train: expected launches {expected}, got "
                                 f"{launches}")
        return launches, seconds

    launches, seconds = run(TWO_VIEW_STEPS, 1, TWO_VIEW_STEPS)
    _, resume_seconds = run(TWO_VIEW_STEPS + TWO_VIEW_RESUME, 2, TWO_VIEW_RESUME)
    with open(os.path.join(out, "losses.txt")) as f:
        header, *rows = [line.split() for line in f.read().splitlines()]
    steps = [int(r[2]) for r in rows]
    values = np.array([[float(x) for x in r[3:]] for r in rows])
    root = os.path.join(out, "checkpoints")
    columns = {"loss", "supervised_loss", "reconstruction_loss", "left_right_loss"}
    if (steps != list(range(1, TWO_VIEW_STEPS + TWO_VIEW_RESUME + 1))
            or not columns <= set(header) or not np.isfinite(values).all()
            or native.load_train_state(root, 1)["step"] != TWO_VIEW_STEPS + TWO_VIEW_RESUME):
        raise AssertionError(f"two-view train: steps {steps}, header {header}, {values}")
    col = {k: values[:, header.index(k) - 3] for k in sorted(columns)}
    log(f"two-view train: {TWO_VIEW_STEPS} steps at B={TRAIN_B} {H0}x{W0} D={D} in "
        f"{seconds:.1f} s, resumed for {TWO_VIEW_RESUME} in {resume_seconds:.1f} s "
        f"(loader start-up, first calls and checkpoints included); launches {launches}; "
        f"losses.txt has {len(header) - 3} columns, all finite: "
        + "; ".join(f"{k} {[round(float(x), 4) for x in v]}" for k, v in col.items()))

    # One batch of the recipe, as the loader gives it, adapted to the two-view step.
    dataset = train_cli.make_dataset(cfg, data_dir, split, True, 0, np.random.default_rng(1))
    batch = collate([dataset[i] for i in range(TRAIN_B)])
    batch = train_cli.two_view_batch({k: torch.as_tensor(v).to(dev) for k, v in batch.items()
                                      if not k.endswith("filenames")})
    state0 = random_state_dict(0)

    def fresh(impl):
        model = MultiViewStereoNet()
        model.load_state_dict(state0)
        model = model.to(dev)
        config, loss_config, _, step = train_cli.build_train_step(cfg, 12, model, impl)
        return model, config, loss_config, step

    grads, loss_of, step_launches = {}, {}, None
    for impl in ("auto", "plain"):
        model, config, loss_config, _ = fresh(impl)
        loss_fn = make_loss_fn(config, loss_config, multi_view=False,
                               estimate_right_idepthmap=True, impl=impl)
        zero_launches()
        loss, loss_dict = loss_fn(model, batch)
        forward = read_launches()
        loss.backward()
        torch.cuda.synchronize()
        expected = two_view_launches(1) if impl == "auto" else dict.fromkeys(forward, 0)
        if not (forward == read_launches() == expected):
            raise AssertionError(f"two-view {impl}: forward launches {forward}, after the "
                                 f"backward {read_launches()}, expected {expected}")
        loss_of[impl] = {k: loss_dict[k].item() for k in ("supervised_loss", "left_right_loss",
                                                          "reconstruction_loss")}
        loss_of[impl]["loss"] = loss.item()
        grads[impl] = {k: p.grad for k, p in model.named_parameters()}
        if impl == "auto":
            step_launches = forward
            log(f"two-view step launches: {forward} (K1: 2 a forward, two forwards, and "
                f"{loss_warp_launches(NUM_LEVELS)} in the losses), backward none")
    worst, worst_key, min_cos = compare_gradients(grads)
    loss_gap = abs(loss_of["auto"]["loss"] - loss_of["plain"]["loss"]) / abs(
        loss_of["plain"]["loss"])
    log(f"two-view step kernel vs plain (TF32 off, same weights and batch): losses "
        f"{loss_of['auto']} vs {loss_of['plain']} ({loss_gap:.2e} relative, bar "
        f"{LOSS_BAR:.0e}); worst gradient {worst:.3e} of max|plain| at {worst_key} (bar "
        f"{GRAD_BAR:.1e}), least cosine {min_cos:.9f} (bar {COS_BAR}), over "
        f"{len(grads['plain'])} parameters")
    if not (np.isfinite(loss_of["auto"]["loss"]) and loss_gap <= LOSS_BAR
            and worst <= GRAD_BAR and min_cos > COS_BAR):
        raise AssertionError("the kernel path's two-view gradients miss the bar")
    del grads

    steps_by = {impl: fresh(impl) for impl in ("auto", "plain")}
    times, peak = time_steps(steps_by, batch, per_round=3)
    ms = {impl: statistics.median(t) for impl, t in times.items()}
    for impl in ("auto", "plain"):
        log(f"two-view step {'kernel' if impl == 'auto' else 'plain'} path, B={TRAIN_B} "
            f"{H0}x{W0} D={D}, adam, every loss: {ms[impl]:.3f} ms a step (median of "
            f"{len(times[impl])}, CUDA events; {[round(t, 2) for t in times[impl]]}), "
            f"{TRAIN_B * 1e3 / ms[impl]:.2f} images/s, peak memory "
            f"{peak[impl] / 2**30:.3f} GiB ({smi})")
    # Device time of one kernel-path step (torch.profiler, kernels summed), of its
    # forward (both forwards and the losses) alone, and the top device operations.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    model, config, loss_config, step = steps_by["auto"]
    loss_fn = make_loss_fn(config, loss_config, multi_view=False,
                           estimate_right_idepthmap=True)
    forward = device_ms(lambda: loss_fn(model, batch), reps=3, warmup=1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(model, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e3
    log(f"two-view step profile (kernel path, one step): device busy {busy:.3f} ms of "
        f"{wall:.3f} ms wall (profiler on), idle {max(0.0, 1 - busy / wall):.1%}; the "
        f"forward (two forwards and the losses) alone {forward:.3f} ms device (mean of 3), "
        f"the backward and the optimizer step {busy - forward:.3f} ms ({smi})")
    log(prof.key_averages().table(sort_by="self_device_time_total", row_limit=15))
    summary = {"ms": ms, "peak_gib": {k: v / 2**30 for k, v in peak.items()},
               "grad_err": worst, "loss_gap": loss_gap,
               "device": {"forward_ms": forward, "busy_ms": busy, "wall_ms": wall}}
    return step_launches, summary


def loss_warp_launches(levels):
    """K1 launches of ``compute_losses`` with the right view's outputs and every branch
    on, over ``levels`` refined levels: occlusion masks 2 a level and 2 of the truth,
    left-right consistency 4 a level, reconstruction 2 a level."""
    return 2 * levels + 2 + 4 * levels + 2 * levels


def two_view_launches(steps):
    """Launches of ``steps`` two-view steps at the recipe: two forwards at (B, 1) a step,
    and the losses' samples."""
    total = expected_launches([(TRAIN_B, 1)] * 2 * steps)
    total["warp"] += steps * loss_warp_launches(NUM_LEVELS)
    return total


def compare_gradients(grads):
    """(worst, its parameter, least cosine) of grads["auto"] against grads["plain"] (dicts
    of parameter gradients): per parameter max|diff| over max|plain|, a leaf below
    GRAD_FLOOR of the largest held to that floor; the cosine above the floor."""
    ref = grads["plain"]
    floor = GRAD_FLOOR * max(r.abs().max().item() for r in ref.values())
    worst, worst_key, min_cos = 0.0, None, 1.0
    for k, r in ref.items():
        a = grads["auto"][k]
        err = (a - r).abs().max().item() / max(r.abs().max().item(), floor)
        if err > worst:
            worst, worst_key = err, k
        if r.abs().max().item() > floor:
            min_cos = min(min_cos, torch.nn.functional.cosine_similarity(
                a.flatten().double(), r.flatten().double(), dim=0).item())
    return worst, worst_key, min_cos


def time_steps(steps_by, batch, rounds=2, per_round=4):
    """Train steps on one batch, the paths of ``steps_by`` ({impl: (model, _, _, step)})
    in turns after two warm-up steps each: (CUDA-event ms of each step by path, peak
    memory by path). A non-finite loss raises."""
    times = {impl: [] for impl in steps_by}
    peak = {}
    for impl, (model, _, _, step) in steps_by.items():
        for _ in range(2):
            loss, _ = step(model, batch)
    for _ in range(rounds):
        for impl, (model, _, _, step) in steps_by.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for _ in range(per_round):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                loss, _ = step(model, batch)
                end.record()
                end.synchronize()
                times[impl].append(start.elapsed_time(end))
                if not np.isfinite(loss.item()):
                    raise AssertionError(f"{impl}: a non-finite loss")
            peak[impl] = max(peak.get(impl, 0), torch.cuda.max_memory_allocated())
    return times, peak


def tests_module(name):
    """tests/<name>.py, loaded by path: an installed package named ``tests`` may shadow
    the repo's."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tests", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def synthetic_data():
    return tests_module("synthetic_data")


def write_run(root, comparisons, seed):
    """A synthetic 480x640 GTA-SfM tree with 6 - 2 * comparisons requests;
    returns (data_dir, split)."""
    return synthetic_data().make_gta_sfm_tree(
        os.path.join(root, f"v{comparisons}"), num_sequences=1, frames=6 - comparisons,
        rows=H0, cols=W0, seed=seed, comparisons=comparisons)


def kernel_modules():
    from multi_view_stereonet_tpu_torch.ops.cuda import gn_apply
    from multi_view_stereonet_tpu_torch.ops.cuda import incremental_chain as chain
    from multi_view_stereonet_tpu_torch.ops.cuda import refiner as refiner_op
    from multi_view_stereonet_tpu_torch.ops.cuda import warp
    return {"warp": warp, "chain": chain, "refiner": refiner_op, "gn_apply": gn_apply}


def zero_launches():
    for module in kernel_modules().values():
        module.launches = 0


def read_launches():
    return {name: module.launches for name, module in kernel_modules().items()}


def expected_launches(forwards):
    """Launches of 480x640 forwards at these (B, V), all refiners on: 2 grid samples and
    1 chain each; K3 for refiner 4 (n = B*V) and refiner 3 (n = B) where
    ``fused_refiner_supported`` takes them, and 7 GroupNorm launches (bn0 + 6
    resblocks) for each of those it does not; 31 GroupNorm launches otherwise."""
    from multi_view_stereonet_tpu_torch.ops.cuda.refiner import fused_refiner_supported

    total = {"warp": 0, "chain": 0, "refiner": 0, "gn_apply": 0}
    for B, V in forwards:
        fused = (fused_refiner_supported(H0 // 16, W0 // 16, B * V)
                 + fused_refiner_supported(H0 // 8, W0 // 8, B))
        total["warp"] += 2
        total["chain"] += 1
        total["refiner"] += fused
        total["gn_apply"] += 31 + 7 * (2 - fused)
    return total


def write_inputs(root):
    """The run directory (params.yaml: 480x640, D = 12, cost filter on, five refiners;
    seeded fan-in-scale weights as stereo_network.pth) and the synthetic trees: GTA-SfM
    at V = 1 (four requests) and V = 2 (two), and DeMoN (one scene of each of two types,
    three frames each, plane depth 4.0)."""
    import yaml

    from multi_view_stereonet_tpu_torch.checkpoint import random_state_dict
    from multi_view_stereonet_tpu_torch.eval.streaming import WEIGHTS_FILE

    run_dir = os.path.join(root, "run")
    weights_dir = os.path.join(run_dir, "checkpoints", "epoch0000")
    os.makedirs(weights_dir)
    with open(os.path.join(run_dir, "params.yaml"), "w") as f:
        yaml.safe_dump({"size": [H0, W0], "num_idepth_samples": D,
                        "cost_volume_filter": True, "refiners": [True] * 5}, f)
    torch.save(random_state_dict(0), os.path.join(weights_dir, WEIGHTS_FILE))
    t0 = time.perf_counter()
    trees = {v: write_run(root, v, seed=v) for v in (1, 2)}
    demon = synthetic_data().make_demon_tree(os.path.join(root, "demon"), num_scenes=1,
                                             frames=3, rows=H0, cols=W0, plane_depth=4.0)
    long = synthetic_data().make_gta_sfm_tree(
        os.path.join(root, "long"), num_sequences=1, frames=LONG + 1, rows=H0, cols=W0,
        seed=3, comparisons=1)
    log(f"inputs: wrote synthetic 480x640 trees in {time.perf_counter() - t0:.1f} s")
    return {"root": root, "weights_dir": weights_dir,
            "params_yaml": os.path.join(run_dir, "params.yaml"), "trees": trees,
            "demon": demon, "long": long}


def serve(dev, inputs):
    """Phase 4: the serving slice through StreamingRunner; returns launch counts and ms."""
    from multi_view_stereonet_tpu_torch.eval.streaming import (
        MODEL_KEYS, StreamingRunner, load_model, make_dataset, model_config_from_params,
        serving_forward)
    from multi_view_stereonet_tpu_torch.train.config import load_params_yaml

    cfg = load_params_yaml(inputs["params_yaml"])
    config = model_config_from_params(cfg)
    model = load_model(inputs["weights_dir"], dev)
    datasets = {v: make_dataset(data_dir, split, cfg, decode_backend="pil")
                for v, (data_dir, split) in inputs["trees"].items()}

    def serve_all(impl):
        runner = StreamingRunner(model, config, device=dev, impl=impl)
        outs = []
        for v in (1, 2):
            for idepth, names in runner.run(datasets[v], batch_size=1, workers=1):
                outs.append((v, idepth, names))
        return outs

    zero_launches()
    served = serve_all("auto")
    launches = read_launches()
    n_forward = len(served)
    log(f"serving: {n_forward} forwards "
        f"({sum(v == 1 for v, _, _ in served)} at V=1, {sum(v == 2 for v, _, _ in served)} at V=2); "
        f"launches {launches}")
    expected = expected_launches([(1, v) for v, _, _ in served])
    if launches != expected:
        raise AssertionError(f"expected launches {expected}, got {launches}")
    plain = serve_all("plain")
    if read_launches() != launches:
        raise AssertionError("impl='plain' launched a kernel")
    worst = 0.0
    for (v, got, names), (_, ref, _) in zip(served, plain):
        if not (isinstance(got, np.ndarray) and got.shape == (1, H0, W0)
                and np.isfinite(got).all()):
            raise AssertionError(f"bad output for {names}: {type(got)} {got.shape}")
        rng = float(ref.max() - ref.min())
        rel = float(np.abs(got - ref).max()) / rng
        worst = max(worst, rel)
        log(f"serving V={v} {os.path.basename(names[0])}: shape {got.shape}, finite, "
            f"range {rng:.4f}, max|kernel - plain| / range {rel:.3e} (bar {SERVE_BAR:.0e})")
        if not rel <= SERVE_BAR:
            raise AssertionError("serving output disagrees with the plain path")

    # ms per frame at B = 1, V = 1 on one batch already on the card.
    sample = datasets[1][0]
    batch = {"left_image": sample["left_image"], "K": sample["K"],
             "right_images": np.stack(sample["right_images"]),
             "T_right_in_left": np.stack(sample["T_right_in_left"])}
    tensors = {k: torch.as_tensor(np.asarray(batch[k], np.float32)[None]).to(dev)
               for k in MODEL_KEYS}
    with torch.inference_mode():
        ms = {impl: median_ms(lambda: serving_forward(model, tensors, config, impl))
              for impl in ("auto", "plain")}
    return launches, ms, worst


def read_table(path):
    """(header, filenames, values (rows, columns)) of a metrics file."""
    with open(path) as f:
        lines = f.read().splitlines()
    header = lines[0].split()
    values = np.array([[float(x) for x in line.split()[1:]] for line in lines[1:]])
    return header, [line.split()[0] for line in lines[1:]], values.reshape(-1, len(header) - 1)


def table_gap(got_path, ref_path):
    """The worst gap of a kernel table against its plain table, as a fraction of its bar
    (<= 1 passes): a1-a3 absolute over 1e-3, every other column relative over 1e-4, NaN
    equal to NaN; the same header and filenames in the same order."""
    header, names, got = read_table(got_path)
    ref_header, ref_names, ref = read_table(ref_path)
    if header != ref_header or names != ref_names or got.shape != ref.shape:
        raise AssertionError(f"{got_path}: header or rows differ from the plain run's")
    worst = 0.0
    for j, key in enumerate(header[1:]):
        if key == "runtime_ms":
            continue
        a, b = got[:, j], ref[:, j]
        if not np.array_equal(np.isnan(a), np.isnan(b)):
            raise AssertionError(f"{got_path} {key}: NaN rows differ")
        ok = ~np.isnan(b)
        if key in RATIOS:
            gap = np.abs(a[ok] - b[ok]) / EVAL_DELTA_BAR
        else:
            gap = np.abs(a[ok] - b[ok]) / (EVAL_REL_BAR * np.abs(b[ok]))
        worst = max([worst] + list(np.nan_to_num(gap, nan=np.inf)))
    return worst


def evaluate(dev, inputs, smi):
    """Phase 5: the eval CLI on the card, kernel and plain paths."""
    from multi_view_stereonet_tpu_torch.eval.test_cli import load_data, run_eval
    from multi_view_stereonet_tpu_torch.train.config import load_params_yaml

    cfg = load_params_yaml(inputs["params_yaml"])
    runs = {"gta_sfm V=1": (*inputs["trees"][1], 2), "DeMoN": (*inputs["demon"], 1)}
    worst = 0.0
    for name, (data_dir, split, batch_size) in runs.items():
        n = len(load_data(data_dir, split, cfg).dataset)
        batches = [min(batch_size, n - i) for i in range(0, n, batch_size)]
        forwards = batches + list(dict.fromkeys(batches))  # each new shape warmed once
        outs = {}
        for impl in ("auto", "plain"):
            out = os.path.join(inputs["root"], f"eval {name} {impl}".replace(" ", "_"))
            zero_launches()
            loss, avg = run_eval(inputs["weights_dir"], data_dir, split, out,
                                 batch_size=batch_size, decode_backend="pil", device=dev,
                                 impl=impl)
            launches = read_launches()
            expected = (expected_launches([(b, 1) for b in forwards]) if impl == "auto"
                        else dict.fromkeys(launches, 0))
            log(f"eval {name} impl={impl}: {n} images at batch {batch_size}, "
                f"{len(forwards)} forwards, launches {launches}, avg loss {loss:.4f}, "
                f"abs_rel {avg['abs_rel']:.4f}")
            if launches != expected:
                raise AssertionError(f"eval {name} impl={impl}: expected launches "
                                     f"{expected}, got {launches}")
            files = sorted(os.listdir(out))
            needed = {"losses.txt", "depth_metrics.txt", "runtime_metrics.txt",
                      "avg_losses.txt", "avg_depth_metrics.txt", "avg_runtime_metrics.txt"}
            if "demon" in split:
                needed |= {f"depth_metrics_{t}.txt" for t in ("mvs", "sun3d", "rgbd",
                                                               "scenes11")}
                needed |= {"avg_depth_metrics_mvs.txt", "avg_depth_metrics_sun3d.txt"}
            if not needed <= set(files) or not np.isfinite(loss):
                raise AssertionError(f"eval {name} impl={impl}: files {files}, loss {loss}")
            outs[impl] = (out, files)
        if outs["auto"][1] != outs["plain"][1]:
            raise AssertionError(f"eval {name}: the kernel and plain runs wrote other files")
        for fname in outs["auto"][1]:
            if fname.endswith(".txt") and not fname.startswith("avg_"):
                gap = table_gap(os.path.join(outs["auto"][0], fname),
                                os.path.join(outs["plain"][0], fname))
                worst = max(worst, gap)
                if not gap <= 1.0:
                    raise AssertionError(f"eval {name} {fname}: kernel rows off the plain "
                                         f"rows by {gap:.3f} of the bar")
    log(f"eval: worst gap of kernel rows to plain rows {worst:.4f} of the bar (a1-a3 "
        f"{EVAL_DELTA_BAR:.0e} absolute, other columns {EVAL_REL_BAR:.0e} relative)")

    data_dir, split = inputs["long"]
    runtimes = {}
    for batch_size in (1, 2):
        out = os.path.join(inputs["root"], f"eval_long_b{batch_size}")
        run_eval(inputs["weights_dir"], data_dir, split, out, batch_size=batch_size,
                 decode_backend="pil", device=dev)
        _, names, values = read_table(os.path.join(out, "runtime_metrics.txt"))
        ms = values[:, 0]
        if len(names) != LONG or not np.isfinite(ms).all():
            raise AssertionError(f"eval over the long tree: {len(names)} rows, {ms}")
        runtimes[batch_size] = float(np.median(ms))
        log(f"eval gta_sfm V=1 B={batch_size}: runtime_ms per image median "
            f"{np.median(ms):.3f}, mean {ms.mean():.3f}, quartiles "
            f"{np.percentile(ms, 25):.3f}-{np.percentile(ms, 75):.3f}, over {LONG} "
            f"480x640 images after one warm-up a batch shape ({smi})")
    return worst, runtimes


def transport(dev, inputs, smi):
    """Phase 6: the u8 transport and the readback on the card."""
    from multi_view_stereonet_tpu_torch.eval.streaming import (
        IN_FLIGHT, StreamingRunner, load_model, make_dataset, model_config_from_params)
    from multi_view_stereonet_tpu_torch.ops.quantize import (
        dequantize_images_u8, dequantize_images_u8_unit)
    from multi_view_stereonet_tpu_torch.train.config import load_params_yaml

    u = np.arange(256, dtype=np.uint8)
    unit = u.astype(np.float32) / 255.0
    full = unit * 2.0 - 1.0
    u_dev = torch.from_numpy(u).to(dev)
    got_full = dequantize_images_u8(u_dev).cpu().numpy()
    got_unit = dequantize_images_u8_unit(u_dev).cpu().numpy()
    naive = (u_dev.float() / 255.0 * 2.0 - 1.0).cpu().numpy()
    log(f"transport: dequantize of all 256 values on the card bit-equal to the host: "
        f"{np.array_equal(got_full.view(np.int32), full.view(np.int32))} (x/255*2-1), "
        f"{np.array_equal(got_unit.view(np.int32), unit.view(np.int32))} (x/255); "
        f"a plain division by 255 on the card differs in "
        f"{int((naive.view(np.int32) != full.view(np.int32)).sum())} of 256")
    if not (np.array_equal(got_full.view(np.int32), full.view(np.int32))
            and np.array_equal(got_unit.view(np.int32), unit.view(np.int32))):
        raise AssertionError("the dequantize on the card is not bit-exact")

    cfg = load_params_yaml(inputs["params_yaml"])
    config = model_config_from_params(cfg)
    model = load_model(inputs["weights_dir"], dev)
    data_dir, split = inputs["trees"][1]
    datasets = {u8: make_dataset(data_dir, split, cfg, "pil", u8_output=u8)
                for u8 in (False, True)}
    n = len(datasets[False])

    def serve_once(batch_size, u8=False, fetch_dtype=None):
        runner = StreamingRunner(model, config, device=dev, fetch_dtype=fetch_dtype)
        outs = [idepth for idepth, _ in runner.run(datasets[u8], batch_size=batch_size)]
        if not all(isinstance(o, np.ndarray) for o in outs):
            raise AssertionError("StreamingRunner.run must yield numpy arrays")
        return np.concatenate(outs)

    zero_launches()
    forwards = []
    for B in (1, 4):
        f32 = serve_once(B)
        u8 = serve_once(B, u8=True)
        f16 = serve_once(B, fetch_dtype=torch.float16)
        forwards += [(min(B, n - i), 1) for i in range(0, n, B)] * 3
        ok_u8 = np.array_equal(u8.view(np.int32), f32.view(np.int32))
        ok_f16 = f16.dtype == np.float16 and np.array_equal(f16, f32.astype(np.float16))
        log(f"transport B={B}: {f32.shape[0]} depthmaps; u8 transport bit-equal to f32: "
            f"{ok_u8}; f16 fetch equal to the f32 output cast: {ok_f16}")
        if not (ok_u8 and ok_f16 and f32.shape == (n, H0, W0) and np.isfinite(f32).all()):
            raise AssertionError(f"transport B={B}: outputs disagree")
    launches = read_launches()
    expected = expected_launches(forwards)
    log(f"transport: launches {launches}")
    if launches != expected:
        raise AssertionError(f"transport: expected launches {expected}, got {launches}")

    # Throughput: one runner a run over the long tree; the steady window leaves out the
    # loader's start-up (the first IN_FLIGHT + 2 results) and the drain (the last
    # IN_FLIGHT, which wait on no new forward).
    long_data = {u8: make_dataset(*inputs["long"], cfg, "pil", u8_output=u8)
                 for u8 in (False, True)}
    rates = {}
    for B in (1, 4):
        for repeat in range(2):
            # The runner's four decode threads, then f32 with one (do they slow the
            # forward's host dispatch?).
            for u8, workers in ((False, 4), (True, 4), (False, 1)):
                runner = StreamingRunner(model, config, device=dev)
                stamps, count = [], 0
                for idepth, names in runner.run(long_data[u8], batch_size=B,
                                                workers=workers):
                    stamps.append(time.perf_counter())
                    count += len(names)
                window = np.array(stamps[IN_FLIGHT + 2:len(stamps) - IN_FLIGHT])
                if count != LONG or len(window) < 8:
                    raise AssertionError(f"transport B={B}: {count} results")
                per_request = float(np.median(np.diff(window))) * 1e3 / B
                rate = B * (len(window) - 1) / float(window[-1] - window[0])
                key = (B, "u8" if u8 else "f32", workers)
                rates.setdefault(key, []).append(rate)
                log(f"transport B={B} {key[1]} workers={workers} run {repeat + 1}: "
                    f"{per_request:.3f} ms a request (median), {rate:.2f} depthmaps/s with "
                    f"the readback over {len(window) - 1} steady steps of {LONG} 480x640 "
                    f"V=1 requests, host decode included ({smi})")
    return rates


def stack_samples(samples):
    """Dataset samples -> one batch of numpy arrays under the model's keys."""
    return {"left_image": np.stack([s["left_image"] for s in samples]),
            "right_images": np.stack([np.stack(s["right_images"]) for s in samples]),
            "K": np.stack([s["K"] for s in samples]).astype(np.float32),
            "T_right_in_left": np.stack([np.stack(s["T_right_in_left"])
                                         for s in samples]).astype(np.float32)}


def artifact_child(path, io_path, device):
    """Phase 9's fresh process: load the artifact at ``path`` (no weights directory, the
    network's modules never imported), run it once on ``device`` on the inputs saved at
    ``io_path`` and print one JSON line: bit-equality with the live output saved there,
    the launch counts of that run, the custom ops in the graph, whether ``models`` was
    imported."""
    sys.path.insert(0, REPO)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from multi_view_stereonet_tpu_torch.checkpoint.export import custom_ops, load_exported

    t0 = time.perf_counter()
    artifact = load_exported(path)
    load_s = time.perf_counter() - t0
    exported = torch.export.load(path)
    constants = sorted(exported.constants.items(), key=lambda kv: -kv[1].nbytes)
    io = np.load(io_path)
    args = [torch.from_numpy(io[k]).to(device) for k in ARTIFACT_KEYS]
    zero_launches()
    with torch.inference_mode():
        out = artifact(*args).cpu().numpy()
    live = io["live"]
    equal = (out.dtype == live.dtype and out.shape == live.shape
             and out.tobytes() == live.tobytes())
    print(json.dumps({"equal": bool(equal), "dtype": str(out.dtype),
                      "launches": read_launches(), "ops": custom_ops(artifact),
                      "models_imported": "multi_view_stereonet_tpu_torch.models" in sys.modules,
                      "load_s": load_s,
                      "weights_bytes": sum(t.nbytes for t in exported.state_dict.values()),
                      "constants_bytes": sum(t.nbytes for _, t in constants),
                      "largest_constants": [[k, list(t.shape)] for k, t in constants[:3]]}),
          flush=True)


def host_us(fn, calls=200) -> float:
    """Host time of one call, in microseconds: ``calls`` calls after 20 warm-ups, the
    host clock around the calls alone (the device keeps up: each kernel takes less)."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return host


def dispatch_costs(dev, model):
    """Each kernel's call through its custom op (the artifact's route) and to its launch
    code directly (the eager route, no dispatcher), host microseconds at a serving
    shape, in turns op, direct, direct, op; medians."""
    from multi_view_stereonet_tpu_torch.ops.cuda import gn_apply
    from multi_view_stereonet_tpu_torch.ops.cuda import incremental_chain as chain
    from multi_view_stereonet_tpu_torch.ops.cuda import refiner as refiner_op
    from multi_view_stereonet_tpu_torch.ops.cuda import warp

    g = torch.Generator().manual_seed(9)

    def rand(*shape):
        return (torch.rand(shape, generator=g) * 2 - 1).to(dev)
    fr = model.right_feature_extractor.refiner
    res = fr.res0
    vec = torch.stack([fr.conv0.bias, fr.bn0.weight, fr.bn0.bias, res.conv1.bias,
                       res.bn1.weight, res.bn1.bias, fr.conv_final.bias])
    pack, dilations = refiner_op.packed_weights(model.refiner4)
    bn = model.left_feature_extractor.res0.bn1
    H_inc = torch.eye(3).repeat(1, D - 1, 1, 1).to(dev)
    cases = {
        "warp": (warp._grid_sample_op, warp._grid_sample_launch,
                 (rand(1, H0, W0, 3), rand(1, H0, W0, 2), True)),
        "chain": (chain._incremental_chain_op, chain._incremental_chain_launch,
                  (rand(1, 30, 40, 32), rand(1, D - 1, 30, 40, 3), H_inc,
                   chain._taps(fr.conv0.weight), chain._taps(res.conv1.weight),
                   chain._taps(fr.conv_final.weight), vec, 0)),
        "refiner": (refiner_op._idepthmap_refiner_op, refiner_op._idepthmap_refiner_launch,
                    (rand(1, 35, 30, 40), rand(1, 30, 40).abs(), pack, list(dilations))),
        "gn_apply": (gn_apply._group_norm_act_op, gn_apply._group_norm_act_launch,
                     (rand(2, 32, 30, 40), bn.weight, bn.bias, rand(2, 32, 30, 40), 4)),
    }
    costs = {}
    with torch.inference_mode():
        for name, (op, launch, args) in cases.items():
            runs = {op: [], launch: []}
            for fn in (op, launch, launch, op):
                runs[fn].append(host_us(lambda: fn(*args)))
            costs[name] = {"op_call_us": statistics.median(runs[op]),
                           "direct_call_us": statistics.median(runs[launch])}
    return costs


def artifact_phase(dev, inputs, smi):
    """Phase 9: the weights as the reference's TorchScript archive, and the serving
    artifact (``checkpoint/export.py``) at B = 1 f32 and at B = 24 u8 / f16."""
    from multi_view_stereonet_tpu_torch.checkpoint import export, load_exported
    from multi_view_stereonet_tpu_torch.checkpoint import random_state_dict
    from multi_view_stereonet_tpu_torch.eval.streaming import (
        StreamingRunner, load_model, make_dataset, model_config_from_params, serving_forward)
    from multi_view_stereonet_tpu_torch.eval.test_cli import run_eval
    from multi_view_stereonet_tpu_torch.train.config import load_params_yaml

    root = inputs["root"]
    pt_run = os.path.join(root, "run_pt")
    pt_dir = os.path.join(pt_run, "checkpoints", "epoch0000")
    os.makedirs(pt_dir)
    with open(inputs["params_yaml"]) as src, open(os.path.join(pt_run, "params.yaml"),
                                                  "w") as dst:
        dst.write(src.read())
    tests_module("reference_archive").write_reference_archive(
        random_state_dict(0), os.path.join(pt_dir, "stereo_network.pt"))
    data_dir, split = inputs["trees"][1]
    outs = {}
    for kind, weights_dir in (("pth", inputs["weights_dir"]), ("pt", pt_dir)):
        outs[kind] = os.path.join(root, f"eval_weights_{kind}")
        run_eval(weights_dir, data_dir, split, outs[kind], decode_backend="pil", device=dev)
    files = sorted(os.listdir(outs["pth"]))
    compared = [f for f in files if "runtime" not in f]
    if sorted(os.listdir(outs["pt"])) != files or not compared:
        raise AssertionError(f"run_eval from .pt wrote other files: {outs}")
    for name in compared:
        texts = [open(os.path.join(outs[k], name)).read() for k in ("pth", "pt")]
        if texts[0] != texts[1]:
            raise AssertionError(f"run_eval from .pt differs from .pth in {name}")
    log(f"weights: run_eval from the reference-layout stereo_network.pt equal to the .pth "
        f"run in {len(compared)} files ({', '.join(compared)})")

    paths = {"b1": os.path.join(root, "serving_b1.pt2"),
             "b24": os.path.join(root, "serving_b24_u8_f16.pt2")}
    export_s = {}
    for name, extra in (("b1", []), ("b24", ["--batch", "24", "--u8", "--fetch",
                                             "float16"])):
        t0 = time.perf_counter()
        export.main([pt_dir, paths[name], "--size", str(H0), str(W0), "--device", str(dev),
                     *extra])
        export_s[name] = time.perf_counter() - t0

    cfg = load_params_yaml(inputs["params_yaml"])
    config = model_config_from_params(cfg)
    model = load_model(inputs["weights_dir"], dev)
    batches = {"b1": stack_samples([make_dataset(data_dir, split, cfg, "pil")[0]])}
    long_u8 = make_dataset(*inputs["long"], cfg, "pil", u8_output=True)
    batches["b24"] = stack_samples([long_u8[i] for i in range(24)])
    fetch = {"b1": None, "b24": torch.float16}
    live = {n: StreamingRunner(model, config, device=dev, fetch_dtype=fetch[n]).forward(
        batches[n]).cpu().numpy() for n in paths}
    expected = {"b1": expected_launches([(1, 1)]), "b24": expected_launches([(24, 1)])}
    all_ops = ["mvs_torch::grid_sample", "mvs_torch::group_norm_act",
               "mvs_torch::idepthmap_refiner", "mvs_torch::incremental_chain"]
    children = {}
    for name in paths:
        io_path = os.path.join(root, f"artifact_io_{name}.npz")
        np.savez(io_path, live=live[name], **batches[name])
        code = (f"import sys; sys.path.insert(0, {REPO!r}); import chip_smoke; "
                f"chip_smoke.artifact_child({paths[name]!r}, {io_path!r}, {str(dev)!r})")
        proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                              text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"artifact {name} in a fresh process failed:\n"
                                 f"{proc.stderr[-3000:]}")
        child = children[name] = json.loads(proc.stdout.strip().splitlines()[-1])
        ops = [op for op in all_ops if name == "b1" or "refiner" not in op]
        log(f"artifact {name} ({os.path.getsize(paths[name])} bytes, exported in "
            f"{export_s[name]:.1f} s) in a fresh process: loaded in {child['load_s']:.1f} s, "
            f"{child['dtype']} output bit-equal to the live runner {child['equal']}, "
            f"launches {child['launches']} (expected {expected[name]}), custom ops "
            f"{child['ops']}, network modules imported {child['models_imported']}; "
            f"{child['weights_bytes']} bytes of weights, {child['constants_bytes']} of "
            f"constants, the largest {child['largest_constants']}")
        if not (child["equal"] and child["launches"] == expected[name]
                and child["ops"] == ops and not child["models_imported"]):
            raise AssertionError(f"artifact {name} fails its contract: {child}")

    with torch.inference_mode():
        for name in paths:
            artifact = load_exported(paths[name])
            tensors = [torch.from_numpy(batches[name][k]).to(dev) for k in ARTIFACT_KEYS]
            batch = dict(zip(ARTIFACT_KEYS, tensors))
            calls = {"artifact": lambda: artifact(*tensors),
                     "live": lambda: serving_forward(model, batch, config,
                                                     fetch_dtype=fetch[name])}
            runs = {"artifact": [], "live": []}
            for turn in ("artifact", "live", "live", "artifact"):
                runs[turn].append(median_ms(calls[turn]) / len(tensors[0]))
            log(f"artifact {name}: ms/frame, median of 20 after warm-up, in turns "
                f"artifact {runs['artifact'][0]:.3f}, live {runs['live'][0]:.3f}, live "
                f"{runs['live'][1]:.3f}, artifact {runs['artifact'][1]:.3f} ({smi})")
    costs = dispatch_costs(dev, model)
    for name, c in costs.items():
        log(f"dispatch {name}: a call through its custom op {c['op_call_us']:.1f} us of "
            f"host, to its launch code directly {c['direct_call_us']:.1f} us ({smi})")
    return {"launches": {n: c["launches"] for n, c in children.items()},
            "dispatch": costs}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this needs an "
                         "NVIDIA card")
    sys.path.insert(0, REPO)
    from multi_view_stereonet_tpu_torch.ops.cuda import build

    smi = nvidia_smi()
    log(f"device: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"count {torch.cuda.device_count()}")
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    sources = ("warp", "incremental_chain", "idepthmap_refiner", "gn_apply")
    t0 = time.perf_counter()
    build.load_libraries(*sources)
    log(f"build {', '.join(s + '.cu' for s in sources)} (parallel): "
        f"{time.perf_counter() - t0:.2f} s")

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        result = fn(*args)
        log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
        return result

    with torch.inference_mode():
        kernels = phase("3 (kernels)", check_kernels, dev)
    backward = phase("3b (backward)", check_backward, dev)
    with tempfile.TemporaryDirectory() as tmp:
        inputs = write_inputs(tmp)
        launches, ms, worst = phase("4 (serving)", serve, dev, inputs)
        log(f"serving ms/frame B=1 V=1 480x640 D=12 ({smi}): kernels {ms['auto']:.3f}, "
            f"plain {ms['plain']:.3f}; worst serving error {worst:.3e} of range")
        phase("5 (eval)", evaluate, dev, inputs, smi)
        phase("6 (transport)", transport, dev, inputs, smi)
        train_launches, trained = phase("7 (train)", train_phase, dev, inputs, smi)
        two_view_step, two_view = phase("8 (two-view train)", two_view_phase, dev, inputs,
                                        smi)
        artifact = phase("9 (weights and artifact)", artifact_phase, dev, inputs, smi)
    log(f"train B={TRAIN_B} V=1 {H0}x{W0} D={D} ({smi}): kernel path "
        f"{trained['ms']['auto']:.3f} ms a step, {trained['images_s']['auto']:.2f} images/s, "
        f"peak {trained['peak_gib']['auto']:.3f} GiB; plain path {trained['ms']['plain']:.3f} "
        f"ms, {trained['images_s']['plain']:.2f} images/s, peak "
        f"{trained['peak_gib']['plain']:.3f} GiB; the CLI loop {trained['cli_ms']:.3f} ms a "
        f"step, the loader alone {trained['loader_ms']:.3f} ms a batch")
    log(f"two-view train B={TRAIN_B} {H0}x{W0} D={D}, every loss ({smi}): kernel path "
        f"{two_view['ms']['auto']:.3f} ms a step, peak {two_view['peak_gib']['auto']:.3f} GiB; "
        f"plain path {two_view['ms']['plain']:.3f} ms, peak "
        f"{two_view['peak_gib']['plain']:.3f} GiB; launches a step {two_view_step}; kernel "
        f"vs plain loss {two_view['loss_gap']:.2e}, worst gradient {two_view['grad_err']:.3e}")

    pkg = "multi_view_stereonet_tpu_torch"
    report = {"kernels": [
        {"name": "grid_sample", "route": "cuda", "source": f"{pkg}/csrc/warp.cu",
         "replaces": "multi_view_stereonet_tpu/ops/pallas/warp_kernel.py:270",
         "launches": launches["warp"], "train_launches": train_launches["warp"],
         "two_view_launches": two_view_step["warp"],
         "artifact_launches": artifact["launches"]["b1"]["warp"],
         "artifact_launches_b24": artifact["launches"]["b24"]["warp"],
         **artifact["dispatch"]["warp"],
         **kernels["warp"],
         "backward": {**backward["K1"], "loss_shapes": [backward["K1 C=1"],
                                                        backward["K1 C=3"]]}},
        {"name": "incremental_chain", "route": "cuda",
         "source": f"{pkg}/csrc/incremental_chain.cu",
         "replaces": "multi_view_stereonet_tpu/ops/pallas/incremental_chain.py:224",
         "launches": launches["chain"], "train_launches": train_launches["chain"],
         "two_view_launches": two_view_step["chain"],
         "artifact_launches": artifact["launches"]["b1"]["chain"],
         "artifact_launches_b24": artifact["launches"]["b24"]["chain"],
         **artifact["dispatch"]["chain"],
         **kernels["chain"], "backward": backward["K2"]},
        {"name": "idepthmap_refiner", "route": "cuda",
         "source": f"{pkg}/csrc/idepthmap_refiner.cu",
         "replaces": "multi_view_stereonet_tpu/ops/pallas/refiner_kernel.py:213",
         "launches": launches["refiner"], "train_launches": train_launches["refiner"],
         "two_view_launches": two_view_step["refiner"],
         "artifact_launches": artifact["launches"]["b1"]["refiner"],
         "artifact_launches_b24": artifact["launches"]["b24"]["refiner"],
         **artifact["dispatch"]["refiner"],
         **kernels["refiner"], "backward": backward["K3"]},
        {"name": "group_norm_act", "route": "cuda", "source": f"{pkg}/csrc/gn_apply.cu",
         "replaces": "multi_view_stereonet_tpu/ops/pallas/gn_apply.py:72",
         "launches": launches["gn_apply"], "train_launches": train_launches["gn_apply"],
         "two_view_launches": two_view_step["gn_apply"],
         "artifact_launches": artifact["launches"]["b1"]["gn_apply"],
         "artifact_launches_b24": artifact["launches"]["b24"]["gn_apply"],
         **artifact["dispatch"]["gn_apply"],
         **kernels["gn_apply"], "backward": backward["K4"]},
    ]}
    log(json.dumps(report))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

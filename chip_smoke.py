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
   device time with 16- and with 8-block clusters forced.
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

Every time and rate printed names the card and its power limit. Before the
last line it prints one JSON line with the kernels' names,
sources, launches, errors, times ("ms" and "plain_ms" are device times of
one call, "call_ms" and "plain_call_ms" a call's time with its host work),
bounds and library times (launches are phase 4's), and the nvidia-smi line;
the last line is {"ok": true, "device": {...}}.
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

    def check_warp(image, grid, what):
        """K1 vs plain; F.grid_sample on the same data, the NCHW copy made outside the
        timed span, is the one PyTorch call for the same function (less the mask)."""
        got, inv = warp.grid_sample(image, grid, zero_invalid=True, impl="kernel")
        ref, inv_ref = warp.grid_sample(image, grid, zero_invalid=True, impl="plain")
        err = (got - ref).abs().max().item()
        t = timings(lambda: warp.grid_sample(image, grid, True, impl="kernel"),
                    lambda: warp.grid_sample(image, grid, True, impl="plain"))
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


def synthetic_data():
    """tests/synthetic_data.py, loaded by path: an installed package named ``tests`` may
    shadow the repo's."""
    spec = importlib.util.spec_from_file_location(
        "synthetic_data", os.path.join(REPO, "tests", "synthetic_data.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


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

    with torch.inference_mode():
        kernels = check_kernels(dev)
    with tempfile.TemporaryDirectory() as tmp:
        inputs = write_inputs(tmp)
        launches, ms, worst = serve(dev, inputs)
        log(f"serving ms/frame B=1 V=1 480x640 D=12 ({smi}): kernels {ms['auto']:.3f}, "
            f"plain {ms['plain']:.3f}; worst serving error {worst:.3e} of range")
        evaluate(dev, inputs, smi)
        transport(dev, inputs, smi)

    pkg = "multi_view_stereonet_tpu_torch"
    report = {"kernels": [
        {"name": "grid_sample", "route": "cuda", "source": f"{pkg}/csrc/warp.cu",
         "replaces": "multi_view_stereonet_tpu/ops/pallas/warp_kernel.py:270",
         "launches": launches["warp"], **kernels["warp"]},
        {"name": "incremental_chain", "route": "cuda",
         "source": f"{pkg}/csrc/incremental_chain.cu",
         "replaces": "multi_view_stereonet_tpu/ops/pallas/incremental_chain.py:224",
         "launches": launches["chain"], **kernels["chain"]},
        {"name": "idepthmap_refiner", "route": "cuda",
         "source": f"{pkg}/csrc/idepthmap_refiner.cu",
         "replaces": "multi_view_stereonet_tpu/ops/pallas/refiner_kernel.py:213",
         "launches": launches["refiner"], **kernels["refiner"]},
        {"name": "group_norm_act", "route": "cuda", "source": f"{pkg}/csrc/gn_apply.cu",
         "replaces": "multi_view_stereonet_tpu/ops/pallas/gn_apply.py:72",
         "launches": launches["gn_apply"], **kernels["gn_apply"]},
    ]}
    log(json.dumps(report))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Time edited copies of a kernel of the port against the kernel as it stands, in one
process.

    python scripts/refiner_variants.py
        [--kernel k3|k3_backward|k2_backward|k1_backward|k4_backward]
        [--tree DIR] [--rounds 2] [--ptxas] [--out FILE]

Builds the kernel's source (``csrc/idepthmap_refiner.cu`` for K3 and its backward,
``csrc/incremental_chain.cu`` for K2's backward, ``csrc/warp.cu`` for K1's backward,
``csrc/gn_apply.cu`` for K4's backward) of
the checkout ``--tree`` (this one
by default; ``git archive`` of another commit unpacked under ``_checkout/`` times that
commit's design) as it stands and each variant below (the same source with a few text
edits), all with the package's nvcc flags, each by its own nvcc at once, then times
each through the tree's own wrapper, which loads the variant's library in place of the
shipped one:

- ``k3``: the forward at (N, 35, h, w) = (1, 35, 30, 40), (8, 35, 30, 40), (1, 35, 60, 80);
- ``k3_backward``: the backward (``refiner.idepthmap_refiner_backward``, every launch it
  makes) at those and the recipe's (8, 35, 60, 80), from one forward with ``keep``;
- ``k2_backward``: the backward (``incremental_chain.incremental_chain_backward``, with
  what its wrapper adds) at N = 1 and 8, 30x40x32, D = 12, and the one-launch design's
  wrapper-side slot sum (``partial.sum(0)``) alone where that wrapper has one;
- ``k1_backward``: the backward (``warp.grid_sample_backward``, with what its wrapper
  adds) at each of a two-view step's calls (``chip_smoke.k1_step_calls``: C = 1 at the
  five levels with both gradients, C = 3 at 480x640 with the grid's only) and at
  ``compare_torch_trees.k1_other_calls``' shapes, each with its ``needs``; the sum of a
  step's 20 calls; and the zero fill of the image's gradient alone (``torch.zeros_like``,
  what the first design's wrapper launches before the kernel);
- ``k4_backward``: the backward (``gn_apply.group_norm_act_backward``, with what its
  wrapper adds) at each shape of a recipe step (``chip_smoke.k4_step_calls``), f32 and
  bf16, and the sum of a step's 31 calls at each; the shipped library also under other
  plans of each shape (``k4_cases``);

the device time of one call, 20 calls replayed from a CUDA graph, median of 7, in the
order shipped, variants, variants reversed, shipped (``--rounds`` times), and prints the
median of each. Two kinds of variant:

- levers: a design choice undone (the result stays right, and is checked against the
  plain version);
- knockouts: one phase of every stage removed (the result is wrong and is not checked),
  to show what that phase costs.

A variant whose text is not in the tree's source is skipped (the knockouts of one
design do not apply to another), and named as skipped. ``--ptxas`` prints nvcc's
``-Xptxas -v`` report (registers, spills) of every build's kernels. Needs a CUDA card; prints the card's name and power limit last.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K3_SHAPES = ((1, 30, 40, "refiner4"), (8, 30, 40, "refiner4"), (1, 60, 80, "refiner3"))
K3_BWD_SHAPES = K3_SHAPES + ((8, 60, 80, "refiner3"),)
K2_SAMPLES = (1, 8)
D = 12

# kernel -> (source, library name, {variant: (kind, [(text in the source, its
# replacement, how many times the text is there)])})
FORWARD = {
    "staging loads after the statistics": ("lever", [(
        "  float4 tv[MT_MAX][3], hv[MT_MAX][3];",
        "  pass_stats(a, l, m, mt, dred, tmp, stat, cur_n, reg);\n"
        "  __syncthreads();\n  float4 tv[MT_MAX][3], hv[MT_MAX][3];", 1), (
        "  pass_stats(a, l, m, mt, dred, tmp, stat, cur_n, reg);\n"
        "  __syncthreads();\n  if (!active) return;",
        "  if (!active) return;", 1)]),
    "rstd in f64": ("lever", [(
        "    tmp[GROUPS + threadIdx.x] = rsqrtf((float)(var + (double)EPS));",
        "    tmp[GROUPS + threadIdx.x] = (float)(1.0 / sqrt(var + (double)EPS));", 1)]),
    "no grid barrier": ("knockout", [(
        "    if (s < LAYERS - 1) grid_barrier(a.barrier);", "    __syncthreads();", 1)]),
    "no conv tap loop": ("knockout", [(
        "    for (int tap = part; tap < 9; tap += ks) {",
        "    for (int tap = part + 9; tap < 9; tap += ks) {", 1)]),
    "no statistics and staging": ("knockout", [(
        "  pass_stats(a, l, m, mt, dred, tmp, stat, cur_n, reg);\n"
        "  __syncthreads();\n  if (!active) return;", "  return;", 1)]),
}


# K3's backward. The one-launch design: every stage stages the input tile X
# beside the gradient tile and runs the weight gradient, the bias sums and the
# per-block slots; the slots are summed over the blocks at the end. The split design
# (two launches): the sequential part writes each conv's output gradient map, and the
# weight-gradient pass computes every weight gradient over the whole card.
K3_BACKWARD = {
    # The one-launch design.
    "no weight-gradient pass and its X staging": ("knockout", [(
        "      if (s == 0)\n        stage_input<T>(a, m, mt, xtile);\n      else\n"
        "        stage_copy(a, m, mt, d, xtile, a.hbuf + l * NPC);\n", "", 1), (
        "      wgrad_pass<BF16, TF32>(a, xtile, gtile, zrow, rows, last ? 1 : GROUPS, m, mt, "
        "d, wacc);\n", "", 1)]),
    "no slot writes (the weight gradient kept)": ("knockout", [(
        "    flush_wgrad(part + grad_offset(a.cin_pad, s), wacc,",
        "    if (a.kp < 0) flush_wgrad(part + grad_offset(a.cin_pad, s), wacc,", 1)]),
    "no final cross-block sum": ("knockout", [(
        "  grid_barrier(a.barrier);\n  // The parameter gradients: the blocks' slots summed "
        "in block order.\n", "", 1), (
        "    for (int b = 0; b < (int)gridDim.x; ++b) sum += __ldcg(a.partial + (int64_t)b * "
        "a.kp + e);\n", "", 1)]),
    "no bias-sum loop": ("knockout", [(
        "          for (int i = 0; i < MTILE; ++i) sum += (double)tile_row(gtile, 1, slot, d + "
        "i)[tid];\n", "", 1)]),
    # Both designs.
    "no input-gradient products": ("knockout", [(
        "    for (int tap = part; tap < 9; tap += ks) {",
        "    for (int tap = part + 9; tap < 9; tap += ks) {", 1)]),
    # The split design.
    "no gradient-map writes": ("knockout", [(
        "          if (kh == 1 && e >= d && e < d + MTILE)\n",
        "          if (kh == 1 && e >= d && e < d + MTILE && a.P < 0)\n", 1)]),
    "passes of three m-tiles (the forward's)": ("lever", [(
        "constexpr int MT_B = 6;", "constexpr int MT_B = 3;", 1)]),
    "no weight-gradient pass": ("knockout", [(
        "refiner_wgrad_kernel(WgradArgs a) {\n",
        "refiner_wgrad_kernel(WgradArgs a) {\n  if (a.N > 0) return;\n", 1)]),
    "no weight-gradient products": ("knockout", [(
        "    for (int s8 = 0; s8 < KB / 8; ++s8) {",
        "    for (int s8 = KB; s8 < KB / 8; ++s8) {", 1)]),
    "no weight-gradient staging": ("knockout", [(
        "  if (begin < end) issue(", "  if (begin < end && end < 0) issue(", 1), (
        "      issue(item + 1, next, next + X_FLOATS);",
        "      if (end < 0) issue(item + 1, next, next + X_FLOATS);", 1), (
        "    if (finish(item, xs, gs)) __syncthreads();",
        "    if (end < 0 && finish(item, xs, gs)) __syncthreads();", 1)]),
    "no weight-gradient block sum": ("knockout", [(
        "  grid_barrier(a.barrier);  // the blocks' slots are written\n", "", 1), (
        "  for (int b = 0; b < nb; ++b) s += __ldcg(src + (int64_t)b * stride);",
        "  s += __ldcg(src);", 1)]),
    "the pass at two blocks an SM": ("lever", [(
        "constexpr int WGRAD_MIN_BLOCKS = 1;", "constexpr int WGRAD_MIN_BLOCKS = 2;", 1)]),
}

# K2's backward. The one-launch design (a cluster a sample): each stage stages the
# conv input X beside the gradient tile (A' re-warps the carry for it) and adds the
# tile's weight gradient into the block's slot of ``partial`` in global memory; the
# wrapper sums the slots. The split design: the cluster keeps each conv's output
# gradient map, and the weight-gradient pass makes X on load over the whole card.
K2_BACKWARD = {
    # The one-launch design.
    "no weight gradients and their X staging": ("knockout", [(
        "      stage_tile(xsrc, xt,", "      if (th < 0) stage_tile(xsrc, xt,", 2), (
        "      stage_warp_tile(xt, carry,", "      if (th < 0) stage_warp_tile(xt, carry,", 1), (
        "      wgrad_tile<BF16, TF32>(", "      if (th < 0) wgrad_tile<BF16, TF32>(", 3), (
        "      wgrad_image_tile<BF16, TF32>(", "      if (th < 0) wgrad_image_tile<BF16, TF32>(",
        1)]),
    "no re-warp in A'": ("knockout", [(
        "      stage_warp_tile(xt, carry,", "      if (th < 0) stage_warp_tile(xt, carry,", 1)]),
    "no slot read-modify-write": ("knockout", [(
        "        o[0] += acc[i][j][2 * r];\n        o[1] += acc[i][j][2 * r + 1];\n",
        "        if (tp < 0) {\n          o[0] += acc[i][j][2 * r];\n"
        "          o[1] += acc[i][j][2 * r + 1];\n        }\n", 1), (
        "      o[0] += acc[2 * r];\n      o[1] += acc[2 * r + 1];\n",
        "      if (tp < 0) {\n        o[0] += acc[2 * r];\n        o[1] += acc[2 * r + 1];\n"
        "      }\n", 1)]),
    # Both designs.
    "no input-gradient convs": ("knockout", [(
        "      conv_tile<C, BF16, TF32>(gt, ", "      if (th < 0) conv_tile<C, BF16, TF32>(gt, ",
        3)]),
    "no warp-transpose atomics": ("knockout", [(
        "        if (!t.ok) return;  // a zeroed sample passes no gradient",
        "        if (!t.ok || th > 0) return;  // a zeroed sample passes no gradient", 1)]),
    # The split design.
    "no gradient-map writes": ("knockout", [(
        "      if (keep != nullptr && ty >= 1 && ty <= th && tx >= 1 && tx <= tw)",
        "      if (keep != nullptr && ty >= 1 && ty <= th && tx >= 1 && tx <= tw && h < 0)", 1)]),
    "no weight-gradient pass": ("knockout", [(
        "chain_wgrad_kernel(WgradArgs a) {\n",
        "chain_wgrad_kernel(WgradArgs a) {\n  if (a.N > 0) return;\n", 1)]),
    "no weight-gradient products": ("knockout", [(
        "    for (int s8 = 0; s8 < KB / 8; ++s8) {",
        "    for (int s8 = KB; s8 < KB / 8; ++s8) {", 1)]),
    "no weight-gradient staging": ("knockout", [(
        "  if (begin < end) issue(", "  if (begin < end && end < 0) issue(", 1), (
        "      issue(item + 1, next, next + X_FLOATS);",
        "      if (end < 0) issue(item + 1, next, next + X_FLOATS);", 1), (
        "    if (finish(item, xs, gs)) __syncthreads();",
        "    if (end < 0 && finish(item, xs, gs)) __syncthreads();", 1)]),
    "no weight-gradient block sum": ("knockout", [(
        "  grid_barrier(a.barrier);  // the blocks' slots are written\n", "", 1), (
        "  for (int b = 0; b < nb; ++b) s += __ldcg(src + (int64_t)b * stride);",
        "  s += __ldcg(src);", 1)]),
    "the pass at one block an SM": ("lever", [(
        "constexpr int WGRAD_MIN_BLOCKS = 2;", "constexpr int WGRAD_MIN_BLOCKS = 1;", 1)]),
}

# K1's backward. The first design (a thread a sample): every nonzero tap of the image's
# gradient is one scalar f32 atomic to device memory, the grid is read and its gradient
# written as two scalars each, and the wrapper zero-fills the image's gradient first. The
# second: a warp's border-clamped samples with the same taps summed by their first lane,
# the grid and its gradient as 8 bytes, the entry zeroing the gradient by cudaMemsetAsync.
K1_BACKWARD = {
    # Both designs: every f32 atomic to device memory (``add_tap``).
    "no image-gradient atomics": ("knockout", [(
        "  if (v != 0.0f) atomicAdd(p, v);", "  if (v != 0.0f && p == nullptr) atomicAdd(p, v);",
        1)]),
    # The first design.
    "no grid-gradient tap reads and arithmetic": ("knockout", [(
        "    if (dgrid != nullptr) {\n      float a[CC], b[CC], c[CC], e[CC];",
        "    if (dgrid == (float*)16) {\n      float a[CC], b[CC], c[CC], e[CC];", 1)]),
    # The second design.
    "no warp sums of clamped samples": ("lever", [(
        "    if (__any_sync(0xffffffffu, u.clamped)) {", "    if (false) {", 1)]),
    "no zeroing (cudaMemsetAsync)": ("knockout", [(
        "  if (dimage != nullptr) {\n    const cudaError_t err = cudaMemsetAsync(",
        "  if (dimage == (float*)16) {\n    const cudaError_t err = cudaMemsetAsync(", 1)]),
    "no grid gradient (tap reads, arithmetic, writes)": ("knockout", [(
        "    if (dgrid != nullptr && u.on) {", "    if (dgrid == (float*)16 && u.on) {", 1)]),
}

# K4's backward. The wave design: each wave of whole rows held between its two passes,
# one grid barrier a wave, a block's next wave started as soon as its own pass 2 is done.
K4_BACKWARD = {
    "no second read of the part not held": ("knockout", [(
        "V::load_last(gx + i)", "V::load(sx + (i & 7))", 1), (
        "V::load_last(gdy + i)", "V::load(sdy + (i & 7))", 1)]),
    "no grid barrier between a wave's passes": ("knockout", [(
        "    grid_barrier(a.barrier);\n\n    // 2. dx", "    __syncthreads();\n\n    // 2. dx",
        1)]),
    "no f64 sums in pass 1": ("knockout", [(
        "              sums[0] += (double)gv;\n              sums[1] += (double)gv * (double)xh;"
        "\n              sums[2] += (double)xh;\n",
        "              if (gv * xh == 1234.5f) sums[0] += 1.0;\n", 1)]),
    "a grid barrier after each wave (no overlap of the next wave's loads)": ("lever", [(
        "      dx_range<VEC>(a, win, rtab, sx, sdy, lo, hi < h ? hi : h);\n    }\n  }\n",
        "      dx_range<VEC>(a, win, rtab, sx, sdy, lo, hi < h ? hi : h);\n    }\n"
        "    if (WAVES && w + 1 < g.waves) grid_barrier(a.barrier);\n  }\n", 1)]),
    "dx stored as any other store (not evict first)": ("lever", [(
        "V::store_last(a.dx + s.s0 + i, o);", "V::store(a.dx + s.s0 + i, o);", 1)]),
}

KERNELS = {"k3": ("idepthmap_refiner", FORWARD),
           "k3_backward": ("idepthmap_refiner", K3_BACKWARD),
           "k2_backward": ("incremental_chain", K2_BACKWARD),
           "k1_backward": ("warp", K1_BACKWARD),
           "k4_backward": ("gn_apply", K4_BACKWARD)}


def smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def edited(files: dict, edits) -> dict | None:
    """{name: text} of the sources (the kernel's .cu and every .cuh header) with every
    edit made, or None where an edit's text is not in them as often as it says."""
    files = dict(files)
    for old, new, count in edits:
        if sum(text.count(old) for text in files.values()) != count:
            return None
        files = {name: text.replace(old, new) for name, text in files.items()}
    return files


def build_all(tree: str, source: str, variants: dict, tmp: str, ptxas: bool):
    """({name: the built library's path}, [skipped variants]); every source built by its
    own nvcc at once, each variant from a directory of its own that holds the kernel's
    source and the headers, edited. With ``ptxas`` each build prints nvcc's -Xptxas -v
    report."""
    from multi_view_stereonet_tpu_torch.ops.cuda import build

    csrc = os.path.join(tree, "multi_view_stereonet_tpu_torch", "csrc")
    base = {name: open(os.path.join(csrc, name)).read() for name in os.listdir(csrc)
            if name == f"{source}.cu" or name.endswith(".cuh")}
    procs, skipped = {}, []
    for i, name in enumerate(["shipped", *variants]):
        files = base if name == "shipped" else edited(base, variants[name][1])
        if files is None:
            skipped.append(name)
            continue
        here = os.path.join(tmp, f"v{i}")
        os.makedirs(here)
        for fname, text in files.items():
            with open(os.path.join(here, fname), "w") as f:
                f.write(text)
        cu, so = os.path.join(here, f"{source}.cu"), os.path.join(tmp, f"v{i}.so")
        extra = ["-Xptxas", "-v"] if ptxas else []
        procs[name] = (subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, *extra, "-o", so,
                                         cu], stderr=subprocess.PIPE, text=True), so)
    paths = {}
    for name, (proc, so) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for variant {name!r}:\n{err}")
        if ptxas:
            print_ptxas(name, err)
        paths[name] = so
    return paths, skipped


def print_ptxas(variant: str, report: str) -> None:
    """Each kernel's registers and spills from a -Xptxas -v report of a variant's build."""
    kernel = None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kernel = m.group(1)
        elif kernel and ("registers" in line or "spill" in line):
            print(f"ptxas [{variant}] {kernel}: {line.split('ptxas info    :')[-1].strip()}",
                  flush=True)


def graph_ms(call, reps=20):
    """One call's device time: ``reps`` calls replayed from a CUDA graph, median of 7."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            call()
    times = []
    for _ in range(7):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def k3_cases(dev, backward: bool) -> list:
    """(label, call, check) a shape: the forward's call and a check of its output against
    its plain version's, or the backward's call on what one forward with ``keep`` (the
    shipped library's) saved and no check."""
    import torch

    from multi_view_stereonet_tpu_torch.checkpoint import random_state_dict
    from multi_view_stereonet_tpu_torch.models import IDepthmapRefiner
    from multi_view_stereonet_tpu_torch.ops.cuda import refiner as refiner_op

    state = random_state_dict(4)
    g = torch.Generator().manual_seed(0)
    cases = []
    for n, h, w, name in K3_BWD_SHAPES if backward else K3_SHAPES:
        module = IDepthmapRefiner(35)
        module.load_state_dict({k[len(name) + 1:]: v for k, v in state.items()
                                if k.startswith(name + ".")})
        module = module.to(dev).eval()
        guidance = (torch.rand(n, 35, h, w, generator=g) * 2 - 1).to(dev)
        idepth = (torch.rand(n, h, w, generator=g) * 20).to(dev)
        label = f"({n},35,{h},{w})"
        if not backward:
            with torch.inference_mode():
                ref = refiner_op.idepthmap_refiner(module, guidance, idepth, impl="plain")
            cases.append((label, lambda m=module, gu=guidance, i=idepth:
                          refiner_op.idepthmap_refiner_kernel(m, gu, i),
                          lambda got, ref=ref: torch.allclose(
                              got, ref, atol=2e-5 * ref.abs().max().item(), rtol=2e-4)))
            continue
        grad = torch.randn(n, h, w, generator=g).to(dev)
        dil = refiner_op._dilations(module)

        with torch.no_grad():
            out, (raw, stats, hs, pack) = refiner_op._launch(module, guidance, idepth, False,
                                                             keep=True)
        cases.append((label, lambda gu=guidance, i=idepth, gr=grad, p=pack, o=out, r=raw,
                      st=stats, h_=hs: refiner_op.idepthmap_refiner_backward(
                          gu, i, p, dil, o, r, st, h_, gr), None))
    return cases


def k2_cases(dev) -> list:
    """(label, call, None) a sample count: the backward's call on what one forward with
    ``keep`` (the shipped library's) saved."""
    import torch

    from multi_view_stereonet_tpu_torch.checkpoint import random_state_dict
    from multi_view_stereonet_tpu_torch.models import FeatureRefiner
    from multi_view_stereonet_tpu_torch.ops.cuda import incremental_chain as chain

    prefix = "right_feature_extractor.refiner."
    refiner = FeatureRefiner(32)
    refiner.load_state_dict({k[len(prefix):]: v for k, v in random_state_dict(3).items()
                             if k.startswith(prefix)})
    refiner = refiner.to(dev).eval()
    weights = chain._weight_args(refiner)
    g = torch.Generator().manual_seed(1)
    cases = []
    for n in K2_SAMPLES:
        feats0 = torch.randn(n, 30, 40, 32, generator=g).to(dev)
        image_rest = (torch.rand(n, D - 1, 30, 40, 3, generator=g) * 2 - 1).to(dev)
        H_inc = torch.eye(3).repeat(n, D - 1, 1, 1)
        H_inc[..., 0, 2] = torch.rand(n, D - 1, generator=g) * 2 - 1
        H_inc = H_inc.to(dev)
        grad = torch.randn(n, D, 30, 40, 32, generator=g).to(dev)

        with torch.no_grad():
            out, raw, stats = chain._launch(refiner, feats0, image_rest, H_inc, 0, False,
                                            keep=True)
        cases.append((f"N={n}", lambda im=image_rest, H=H_inc, o=out, r=raw, st=stats,
                      gr=grad: chain.incremental_chain_backward(im, H, *weights, o, r, st, gr),
                      None))
    return cases


def k1_calls(dev) -> list:
    """``chip_smoke.k1_step_calls`` (``chip_smoke.py`` of this script's checkout, its
    package imports from ``--tree``) and ``compare_torch_trees.k1_other_calls``, each with
    an output gradient from a seed."""
    import torch

    from compare_torch_trees import chip_smoke_module, k1_other_calls

    smoke = chip_smoke_module()
    g = torch.Generator().manual_seed(3)
    calls = smoke.k1_step_calls(dev, g) + k1_other_calls(smoke, dev, g)
    for c in calls:
        c["cot"] = torch.randn(c["grid"].shape[:-1] + c["image"].shape[-1:],
                               generator=g).to(dev)
    return calls


def k1_cases(calls) -> list:
    """(label, call, check) a call of ``k1_calls``: the backward, and a check of both
    gradients against its plain version's within 1e-4 of max|plain| (``chip_smoke.py``
    phase 3b's bar; NaN where it has NaN). Both sum a border corner's thousands of taps at
    these grids, each in its own order: two sequential orders part there by 4.4e-6 of
    max on the CPU, and the card's atomics add the order of a run."""
    import torch

    from multi_view_stereonet_tpu_torch.ops.cuda import warp

    def check(got, ref):
        for a, r in zip(got, ref):
            if (a is None) != (r is None):
                return False
            if r is not None:
                keep = ~torch.isnan(r)
                if not (torch.equal(torch.isnan(a), torch.isnan(r)) and
                        (a[keep] - r[keep]).abs().max() <= 1e-4 * r[keep].abs().max()):
                    return False
        return True

    cases = []
    for c in calls:
        args = (c["image"], c["grid"], c["cot"], False, c["needs"])
        ref = warp.grid_sample_backward_plain(*args)
        cases.append((c["label"], lambda a=args: warp.grid_sample_backward(*a),
                      lambda got, ref=ref: check(got, ref)))
    return cases


def k4_cases(dev) -> list:
    """(label, call, check, every) a shape of a recipe step (``chip_smoke.k4_step_calls``)
    and of the serving forward (``GN_SHAPES``, "x0": no call a step) at f32 and bf16 (the
    conv's bias as xbias): the backward kernel as ``plan`` cuts it and
    a check of every gradient against its plain version within 1e-4 of max|plain|
    (phase 3b's bar), for every variant; and, where the tree's ``plan`` takes a share of
    L2 (``reread``), the shipped library alone under other plans of that shape: no share
    of L2, twice the share, one wave over the card (the first design's route) and waves
    where ``plan`` keeps one wave."""
    import inspect

    import torch

    from compare_torch_trees import chip_smoke_module
    from multi_view_stereonet_tpu_torch.ops.cuda import gn_apply

    smoke = chip_smoke_module()
    sms = gn_apply.sm_count(dev)
    g = torch.Generator().manual_seed(4)
    weight = (torch.rand(32, generator=g) + 0.5).to(dev)
    bias = (torch.randn(32, generator=g) * 0.1).to(dev)
    xbias = (torch.randn(32, generator=g) * 0.3).to(dev)
    others = "reread" in inspect.signature(gn_apply.plan).parameters  # the tree plans waves
    cases = []
    serving = list(dict((shape, 0) for shape, _, _ in smoke.GN_SHAPES).items())
    for dtype in (torch.float32, torch.bfloat16):
        for shape, calls in smoke.k4_step_calls() + serving:
            x = (torch.randn(shape, generator=g) * 2 + 0.5).to(dev, dtype)
            dy = torch.randn(shape, generator=g).to(dev, dtype)
            xb = xbias if dtype == torch.bfloat16 else None
            with torch.no_grad():
                _, stats = gn_apply._forward_launch(x, weight, bias, None, 4, xb, stats=True)
                ref = gn_apply.group_norm_act_backward_plain(x, weight, bias, 4, stats, dy, xb)

            def check(got, ref=ref):
                return all((a.float() - r.float()).abs().max() <= 1e-4 * r.float().abs().max()
                           for a, r in zip(got, ref) if r is not None)
            label = f"{tuple(shape)} {str(dtype)[6:]} x{calls}"
            args = (x, weight, bias, 4, stats, dy, xb)
            cases.append((label, lambda a=args: gn_apply.group_norm_act_backward(*a), check,
                          True))
            if not others:
                continue
            p = gn_apply.plan(shape, 4, dtype, sms, backward=True)
            size = x.element_size()
            cap = gn_apply.HOLD_BYTES // (2 * size) // 8 * 8
            one = gn_apply.Plan("partial", sms, 0, cap)
            rows, L = shape[0] * 4, x.numel() // (shape[0] * 4)
            extra = gn_apply.REREAD_BYTES // (2 * size * sms)
            waves = gn_apply.Plan("waves", sms, 0, cap, -(-rows // max(
                1, (cap + extra) // 8 * 8 * sms // L)))
            plans = {"reread 0": gn_apply.plan(shape, 4, dtype, sms, backward=True, reread=0),
                     "reread x2": gn_apply.plan(shape, 4, dtype, sms, backward=True,
                                                reread=2 * gn_apply.REREAD_BYTES)}
            for name, alt in (("one wave", one), ("waves", waves)):
                q = max(q for _, _, q in gn_apply.wave_slices(shape, 4, alt))
                plans[name] = alt._replace(slice=q, held=min(cap, q))
            for name, alt in plans.items():
                if p.route != "resident" and alt != p and (alt.waves > 1) == (
                        alt.route == "waves"):
                    cases.append((f"{label} [{name}: {alt.route}, {alt.waves} waves]",
                                  lambda a=args, r=alt: gn_apply.group_norm_act_backward(
                                      *a, route=r), check, False))
    return cases


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernel", choices=tuple(KERNELS), default="k3")
    parser.add_argument("--tree", default=REPO, help="the checkout whose kernel is timed")
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--ptxas", action="store_true",
                        help="print the shipped source's -Xptxas -v report")
    parser.add_argument("--out", help="write the medians here as JSON")
    args = parser.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    from multi_view_stereonet_tpu_torch.ops.cuda import build, gn_apply
    from multi_view_stereonet_tpu_torch.ops.cuda import incremental_chain as chain
    from multi_view_stereonet_tpu_torch.ops.cuda import refiner as refiner_op

    if not torch.cuda.is_available():
        raise SystemExit("refiner_variants: needs an NVIDIA card")
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    source, variants = KERNELS[args.kernel]

    def use(path):
        """Load ``path`` in place of the shipped library; the wrappers' entries reload."""
        build._libs[source] = ctypes.CDLL(path)
        refiner_op._fns.clear()
        gn_apply._device_cache.clear()

    with tempfile.TemporaryDirectory() as tmp:
        paths, skipped = build_all(tree, source, variants, tmp, args.ptxas)
        names = [v for v in variants if v in paths]
        use(paths["shipped"])
        if args.kernel == "k1_backward":
            calls = k1_calls(dev)
            cases = k1_cases(calls)
        elif args.kernel == "k4_backward":
            cases = k4_cases(dev)
        elif args.kernel == "k2_backward":
            cases = k2_cases(dev)
        else:
            cases = k3_cases(dev, args.kernel == "k3_backward")
        # A case of four is (label, call, check, every): every=False runs with the shipped
        # library only.
        cases = [c if len(c) == 4 else (*c, True) for c in cases]
        order = (["shipped", *names, *names[::-1], "shipped"]) * args.rounds
        times = {(v, c[0]): [] for v in paths for c in cases
                 if c[3] or v == "shipped"}
        for v in order:
            use(paths[v])
            for label, call, check, every in cases:
                if not (every or v == "shipped"):
                    continue
                with torch.inference_mode(check is not None):
                    got = call()
                    if check is not None and (v == "shipped" or variants[v][0] == "lever"):
                        if not check(got):
                            raise SystemExit(f"{v} at {label} disagrees with the plain "
                                             "version")
                    times[(v, label)].append(graph_ms(call))
        use(paths["shipped"])
    medians = {v: {c[0]: statistics.median(times[(v, c[0])]) for c in cases
                   if (v, c[0]) in times} for v in paths}
    if args.kernel == "k2_backward":  # the one-launch wrapper's slot sum alone, if any
        src = open(os.path.join(tree, "multi_view_stereonet_tpu_torch", "ops", "cuda",
                                "incremental_chain.py")).read()
        if "partial.sum(0)" in src:
            row = {}
            for n in K2_SAMPLES:
                cluster = chain.cluster_size(n, 30, 40, dev)
                partial = torch.randn(n * cluster, 9 * 35 * 32 + 2 * 9 * 32 * 32 + 7 * 32,
                                      device=dev)
                row[f"N={n}"] = graph_ms(lambda p=partial: p.sum(0))
            medians["the wrapper's slot sum alone"] = row
    if args.kernel == "k4_backward":
        for v in paths:
            for dtype in ("float32", "bfloat16"):
                medians[v][f"a recipe step's 31 calls, {dtype}"] = sum(
                    int(label.rsplit(" x", 1)[1]) * ms for label, ms in medians[v].items()
                    if dtype in label and "[" not in label and " x" in label)
    if args.kernel == "k1_backward":
        for v in paths:
            medians[v]["a two-view step's 20 calls"] = sum(
                c["calls"] * medians[v][c["label"]] for c in calls)
        medians["the zero fill alone (torch.zeros_like)"] = {
            c["label"]: graph_ms(lambda im=c["image"]: torch.zeros_like(im))
            for c in calls if c["needs"][0]}
    for v, row in medians.items():
        kind = ("shipped" if v == "shipped" else variants[v][0] if v in variants
                else "part")
        print(f"{kind:9s} {v}: " + ", ".join(f"{k} {ms * 1e3:.1f} us" for k, ms in row.items()),
              flush=True)
    for v in skipped:
        print(f"skipped   {v}: its text is not in this tree's source", flush=True)
    card = smi()
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "kernel": args.kernel, "tree": tree,
                       "device_ms": medians, "skipped": skipped}, f, indent=1)
    print(card)


if __name__ == "__main__":
    main()

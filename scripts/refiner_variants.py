#!/usr/bin/env python3
"""Time edited copies of the idepthmap-refiner kernel (K3) against it, in one process.

    python scripts/refiner_variants.py [--rounds 2] [--out FILE]

Builds ``csrc/idepthmap_refiner.cu`` as it stands and each variant below (the
same source with a few text edits), all with the package's nvcc flags, then times
each at the serving shapes (N, 35, h, w) = (1, 35, 30, 40), (8, 35, 30, 40) and
(1, 35, 60, 80): the device time of one call, 20 calls replayed from a CUDA
graph, median of 7, in the order shipped, variants, variants reversed, shipped
(``--rounds`` times), and prints the median of each. Two kinds of variant:

- levers: a design choice undone (the result stays right, and is checked
  against the plain version);
- knockouts: one phase of every stage removed (the result is wrong and is not
  checked), to show what that phase costs.

Needs a CUDA card; prints the card's name and power limit last.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(REPO, "multi_view_stereonet_tpu_torch", "csrc", "idepthmap_refiner.cu")
SHAPES = ((1, 30, 40, "refiner4"), (8, 30, 40, "refiner4"), (1, 60, 80, "refiner3"))

# name -> (kind, [(text in the source, its replacement)])
VARIANTS = {
    "staging loads after the statistics": ("lever", [(
        "  float4 tv[MT_MAX][3], hv[MT_MAX][3];",
        "  pass_stats(a, l, m, mt, dred, tmp, stat, cur_n, reg);\n"
        "  __syncthreads();\n  float4 tv[MT_MAX][3], hv[MT_MAX][3];"), (
        "  pass_stats(a, l, m, mt, dred, tmp, stat, cur_n, reg);\n"
        "  __syncthreads();\n  if (!active) return;",
        "  if (!active) return;")]),
    "correction products in a second accumulator": ("lever", [(
        "  float acc[NJ][4];\n", "  float acc[NJ][4], cor[NJ][4] = {};\n"), (
        "          mma_k8(acc[j], al, bh);\n          mma_k8(acc[j], ah, bl);",
        "          mma_k8(cor[j], al, bh);\n          mma_k8(cor[j], ah, bl);"), (
        "      }\n    }\n  }\n  if (busy)\n",
        "      }\n    }\n    for (int j = 0; j < NJ; ++j)\n"
        "      for (int k = 0; k < 4; ++k) acc[j][k] += cor[j][k];\n  }\n  if (busy)\n")]),
    "rstd in f64": ("lever", [(
        "    tmp[GROUPS + threadIdx.x] = rsqrtf((float)(var + (double)EPS));",
        "    tmp[GROUPS + threadIdx.x] = (float)(1.0 / sqrt(var + (double)EPS));")]),
    "no grid barrier": ("knockout", [(
        "    if (s < LAYERS - 1) grid_barrier(a.barrier);", "    __syncthreads();")]),
    "no conv tap loop": ("knockout", [(
        "    for (int tap = part; tap < 9; tap += ks) {",
        "    for (int tap = part + 9; tap < 9; tap += ks) {")]),
    "no statistics and staging": ("knockout", [(
        "  pass_stats(a, l, m, mt, dred, tmp, stat, cur_n, reg);\n"
        "  __syncthreads();\n  if (!active) return;", "  return;")]),
    "no tap-share sum and epilogue": ("knockout", [(
        "    epi(slot, part, sum);\n", "")]),
}


def smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def build_all(tmp: str) -> dict:
    """name -> the library's kernel entry, every source built by its own nvcc at once."""
    from multi_view_stereonet_tpu_torch.ops.cuda import build

    base = open(SOURCE).read()
    procs = {}
    for i, name in enumerate(["shipped", *VARIANTS]):
        src = base
        for old, new in ([] if name == "shipped" else VARIANTS[name][1]):
            if src.count(old) != 1:
                raise SystemExit(f"variant {name!r}: its text is not in the source once")
            src = src.replace(old, new)
        cu, so = os.path.join(tmp, f"v{i}.cu"), os.path.join(tmp, f"v{i}.so")
        with open(cu, "w") as f:
            f.write(src)
        procs[name] = (subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-o", so, cu]), so)
    fns = {}
    for name, (proc, so) in procs.items():
        if proc.wait() != 0:
            raise SystemExit(f"nvcc failed for variant {name!r}")
        fn = ctypes.CDLL(so).mvs_idepthmap_refiner_f32
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_void_p]
                       + [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--out", help="write the medians here as JSON")
    args = parser.parse_args()
    sys.path.insert(0, REPO)
    import torch

    from multi_view_stereonet_tpu_torch.checkpoint import random_state_dict
    from multi_view_stereonet_tpu_torch.models import IDepthmapRefiner
    from multi_view_stereonet_tpu_torch.ops.cuda import refiner as refiner_op

    if not torch.cuda.is_available():
        raise SystemExit("refiner_variants: needs an NVIDIA card")
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        fns = build_all(tmp)
        state = random_state_dict(4)
        g = torch.Generator().manual_seed(0)
        cases = []
        for n, h, w, name in SHAPES:
            module = IDepthmapRefiner(35)
            module.load_state_dict({k[len(name) + 1:]: v for k, v in state.items()
                                    if k.startswith(name + ".")})
            module = module.to(dev).eval()
            guidance = (torch.rand(n, 35, h, w, generator=g) * 2 - 1).to(dev)
            idepth = (torch.rand(n, h, w, generator=g) * 20).to(dev)
            with torch.inference_mode():
                ref = refiner_op.idepthmap_refiner(module, guidance, idepth, impl="plain")
            cases.append((f"({n},35,{h},{w})", module, guidance, idepth, ref))

        def graph_ms(call, reps=20):
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

        names = list(VARIANTS)
        order = (["shipped", *names, *names[::-1], "shipped"]) * args.rounds
        times = {(v, c[0]): [] for v in fns for c in cases}
        with torch.inference_mode():
            for v in order:
                refiner_op._fn = fns[v]
                for label, module, guidance, idepth, ref in cases:
                    def call():
                        return refiner_op.idepthmap_refiner_kernel(module, guidance, idepth)
                    got = call()
                    if v == "shipped" or VARIANTS[v][0] == "lever":
                        if not torch.allclose(got, ref, atol=2e-5 * ref.abs().max().item(),
                                              rtol=2e-4):
                            raise SystemExit(f"{v} at {label} disagrees with the plain version")
                    times[(v, label)].append(graph_ms(call))
        refiner_op._fn = None
    medians = {v: {c[0]: statistics.median(times[(v, c[0])]) for c in cases} for v in fns}
    for v, row in medians.items():
        kind = "shipped" if v == "shipped" else VARIANTS[v][0]
        print(f"{kind:9s} {v}: " + ", ".join(f"{k} {ms * 1e3:.1f} us" for k, ms in row.items()),
              flush=True)
    card = smi()
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "device_ms": medians}, f, indent=1)
    print(card)


if __name__ == "__main__":
    main()

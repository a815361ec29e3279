#!/usr/bin/env python3
"""Where the time of K4's backward kernel goes, wave by wave, on the card.

    python scripts/k4_wave_timeline.py [--out FILE]

Builds a copy of ``csrc/gn_apply.cu`` in which thread 0 of every block reads
``%globaltimer`` at the phase boundaries of each wave of ``gn_bwd_kernel`` (the wave's
start, pass 1's start, its end, the grid barrier's end, the end of the rows' (a, b), the
end of pass 2), loads it in place of the shipped library and runs the backward once at the
recipe's large shapes, f32 and bf16, as ``plan`` cuts them and in one wave and in the
waves ``plan`` does not take (the other route). Prints, for each wave, the median and the
largest over the blocks of each phase's length (µs), the gap from a block's pass 2 to its
next wave, the wave's start, and the last pass 2's end; the kernel's time with the stamps
(CUDA events around one launch) beside it. Needs a CUDA card; prints the card's name and
power limit last.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAVES_MAX, BLOCKS_MAX, STAMPS = 64, 132, 6
PHASES = ("to pass 1", "pass 1", "barrier", "rows' a, b", "pass 2")


def stamped_source(text: str) -> str:
    """``text`` with the stamps: slot k of block b in wave w at gn_trace[(w B + b) K + k]."""
    def stamp(k):
        return ("if (threadIdx.x == 0) { unsigned long long t_; asm volatile(\"mov.u64 %0, "
                "%%globaltimer;\" : \"=l\"(t_)); "
                f"gn_trace[(w * {BLOCKS_MAX} + b) * {STAMPS} + {k}] = t_; }}")
    edits = [
        ("namespace {\n",
         f"__device__ unsigned long long gn_trace[{WAVES_MAX * BLOCKS_MAX * STAMPS}];\n"
         "namespace {\n"),
        ("  for (int w = 0; w < (WAVES ? g.waves : 1); ++w) {\n",
         "  for (int w = 0; w < (WAVES ? g.waves : 1); ++w) {\n    " + stamp(0) + "\n"),
        ("    const T* const gx = a.x + s0;\n    const T* const gdy = a.dy + s0;\n",
         "    const T* const gx = a.x + s0;\n    const T* const gdy = a.dy + s0;\n    "
         + stamp(1) + "\n"),
        ("    grid_barrier(a.barrier);\n\n    // 2. dx",
         "    " + stamp(2) + "\n    grid_barrier(a.barrier);\n    " + stamp(3)
         + "\n\n    // 2. dx"),
        ("      row_table(a, win, rtab);\n      __syncthreads();\n",
         "      row_table(a, win, rtab);\n      __syncthreads();\n      " + stamp(4) + "\n"),
        ("      dx_range<VEC>(a, win, rtab, sx, sdy, lo, hi < h ? hi : h);\n    }\n",
         "      dx_range<VEC>(a, win, rtab, sx, sdy, lo, hi < h ? hi : h);\n    }\n    "
         + stamp(5) + "\n"),
    ]
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"k4_wave_timeline: the source has changed; not found: {old!r}")
        text = text.replace(old, new)
    return text + ('\nextern "C" int mvs_gn_trace_read(void* dst, size_t bytes) {\n'
                   "  return (int)cudaMemcpyFromSymbol(dst, gn_trace, bytes);\n}\n")


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="write every wave's phases here as JSON")
    args = parser.parse_args()
    sys.path.insert(0, REPO)
    import torch

    from multi_view_stereonet_tpu_torch.ops.cuda import build, gn_apply

    if not torch.cuda.is_available():
        raise SystemExit("k4_wave_timeline: needs an NVIDIA card")
    with tempfile.TemporaryDirectory() as tmp:
        cu, so = os.path.join(tmp, "gn_apply.cu"), os.path.join(tmp, "libgn_trace.so")
        with open(os.path.join(build.CSRC_DIR, "gn_apply.cu")) as f:
            text = stamped_source(f.read())
        with open(cu, "w") as f:
            f.write(text)
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", so, cu], check=True)
        lib = ctypes.CDLL(so)
    build._libs["gn_apply"] = lib
    gn_apply._device_cache.clear()
    dev = torch.device("cuda", 0)
    sms = gn_apply.sm_count(dev)
    if sms > BLOCKS_MAX:
        raise SystemExit(f"k4_wave_timeline: {sms} SMs, the stamps hold {BLOCKS_MAX}")
    g = torch.Generator().manual_seed(0)
    weight = (torch.rand(32, generator=g) + 0.5).to(dev)
    bias = (torch.randn(32, generator=g) * 0.1).to(dev)
    report = []
    for shape in ((8, 32, 480, 640), (8, 32, 240, 320)):
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn(shape, generator=g) * 2 + 0.5).to(dev, dtype)
            dy = torch.randn(shape, generator=g).to(dev, dtype)
            _, stats = gn_apply._forward_launch(x, weight, bias, None, 4, None, stats=True)
            size = x.element_size()
            cap = gn_apply.HOLD_BYTES // (2 * size) // 8 * 8
            rows, L = shape[0] * 4, math.prod(shape) // (shape[0] * 4)
            extra = gn_apply.REREAD_BYTES // (2 * size * sms)
            shipped = gn_apply.plan(shape, 4, dtype, sms, backward=True)
            plans = {"plan": shipped}
            waves = -(-rows // max(1, (cap + extra) // 8 * 8 * sms // L))
            for name, alt in (("one wave", gn_apply.Plan("partial", sms, 0, cap)),
                              ("waves", gn_apply.Plan("waves", sms, 0, cap, waves))):
                q = max(q for _, _, q in gn_apply.wave_slices(shape, 4, alt))
                alt = alt._replace(slice=q, held=min(cap, q))
                if (alt.route, alt.waves) != (shipped.route, shipped.waves) and (
                        alt.waves > 1) == (alt.route == "waves"):
                    plans[name] = alt
            for name, p in plans.items():
                for _ in range(2):
                    gn_apply.group_norm_act_backward(x, weight, bias, 4, stats, dy, route=p)
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                gn_apply.group_norm_act_backward(x, weight, bias, 4, stats, dy, route=p)
                end.record()
                torch.cuda.synchronize()
                buf = (ctypes.c_ulonglong * (WAVES_MAX * BLOCKS_MAX * STAMPS))()
                if lib.mvs_gn_trace_read(buf, ctypes.sizeof(buf)) != 0:
                    raise SystemExit("k4_wave_timeline: could not read the stamps")
                t = [[[buf[(w * BLOCKS_MAX + b) * STAMPS + k] for k in range(STAMPS)]
                      for b in range(p.blocks)] for w in range(p.waves)]
                t0 = min(t[0][b][0] for b in range(p.blocks))
                timeline = []
                for w in range(p.waves):
                    row = {"start_us": statistics.median(
                        (t[w][b][0] - t0) / 1e3 for b in range(p.blocks))}
                    for k, phase in enumerate(PHASES):
                        d = [(t[w][b][k + 1] - t[w][b][k]) / 1e3 for b in range(p.blocks)]
                        row[phase] = (statistics.median(d), max(d))
                    if w + 1 < p.waves:
                        row["to the next wave"] = statistics.median(
                            (t[w + 1][b][0] - t[w][b][5]) / 1e3 for b in range(p.blocks))
                    timeline.append(row)
                last = (max(t[-1][b][5] for b in range(p.blocks)) - t0) / 1e3
                label = f"{shape} {str(dtype)[6:]} {name}: {p}"
                print(f"{label}; with the stamps {start.elapsed_time(end) * 1e3:.1f} us "
                      f"(events), the last pass 2 ends at {last:.1f} us", flush=True)
                for w, row in enumerate(timeline):
                    if w < 3 or w == len(timeline) - 1:
                        phases = ", ".join(f"{k} {row[k][0]:.2f}/{row[k][1]:.2f}"
                                           for k in PHASES)
                        gap = (f", to the next wave {row['to the next wave']:.2f}"
                               if "to the next wave" in row else "")
                        print(f"  wave {w:2d} at {row['start_us']:7.1f} us: {phases}{gap}",
                              flush=True)
                means = {k: statistics.mean(r[k][0] for r in timeline) for k in PHASES}
                print("  mean over the waves: " + ", ".join(
                    f"{k} {v:.2f}" for k, v in means.items()), flush=True)
                report.append({"label": label, "last_us": last, "waves": timeline})
            del x, dy
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "runs": report}, f, indent=1)
    print(card)


if __name__ == "__main__":
    main()

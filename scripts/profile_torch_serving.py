#!/usr/bin/env python3
"""Profile the PyTorch port's serving forward on one NVIDIA card with torch.profiler.

    python scripts/profile_torch_serving.py [--impl auto|plain] [--views 1] [--forwards 5]

B = 1, 480x640, D = 12, cost filter and five refiners on, seeded fan-in-scale
weights, random images and a synthetic camera (the serving configuration of
chip_smoke.py). After three warm-up forwards it profiles ``--forwards``
forwards and prints, per forward: device time by kernel (the 25 largest),
device busy ms, device kernels, host self-CPU ms, wall ms and the device's
idle share of the wall time; then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from multi_view_stereonet_tpu_torch.checkpoint import random_state_dict  # noqa: E402
from multi_view_stereonet_tpu_torch.eval.streaming import serving_forward  # noqa: E402
from multi_view_stereonet_tpu_torch.models import (  # noqa: E402
    MultiViewStereoNet, MultiViewStereoNetConfig)

H0, W0, D = 480, 640, 12


def batch(views, dev):
    rng = np.random.default_rng(0)
    K = np.eye(4, dtype=np.float32)
    K[0, 0] = K[1, 1] = 0.9 * W0
    K[0, 2], K[1, 2] = (W0 - 1) / 2.0, (H0 - 1) / 2.0
    T = np.tile(np.eye(4, dtype=np.float32), (1, views, 1, 1))
    T[0, :, 0, 3] = rng.uniform(0.3, 0.5, size=views)
    arrays = {"left_image": rng.uniform(-1, 1, (1, H0, W0, 3)),
              "right_images": rng.uniform(-1, 1, (1, views, H0, W0, 3)),
              "K": K[None], "T_right_in_left": T}
    return {k: torch.as_tensor(np.asarray(v, np.float32)).to(dev) for k, v in arrays.items()}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--impl", default="auto", choices=["auto", "plain"])
    parser.add_argument("--views", type=int, default=1)
    parser.add_argument("--forwards", type=int, default=5)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_serving: needs an NVIDIA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    model = MultiViewStereoNet()
    model.load_state_dict(random_state_dict(0))
    model = model.to(dev).eval()
    inputs = batch(args.views, dev)
    config = MultiViewStereoNetConfig(num_idepth_samples=D)

    with torch.inference_mode():
        for _ in range(3):
            serving_forward(model, inputs, config, args.impl)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.forwards):
                serving_forward(model, inputs, config, args.impl)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / args.forwards

    n = args.forwards
    averages = prof.key_averages()
    print(averages.table(sort_by="self_device_time_total", row_limit=25))
    device_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in device_events) / 1e3 / n
    kernels = len(device_events) / n
    host_ms = sum(e.self_cpu_time_total for e in averages
                  if e.device_type == DeviceType.CPU) / 1e3 / n
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"impl={args.impl} B=1 V={args.views} {H0}x{W0} D={D}, per forward over {n}: "
          f"device busy {busy_ms:.3f} ms, {kernels:.0f} device kernels, host self-CPU "
          f"{host_ms:.3f} ms, wall {wall_ms:.3f} ms (profiler on), device idle "
          f"{max(0.0, 1 - busy_ms / wall_ms):.1%}")
    print(smi)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""K4 (``ops/cuda/gn_apply.py`` ``group_norm_act``) at bf16 against its plain version
over six seeds at every GroupNorm shape of ``chip_smoke.py`` (the serving forward's and
phase 15's): per shape the worst of |kernel - plain| / (ulp(y) + ulp(plain)), with
and without the f32 floor ``chip_smoke.GN_F32_FLOOR`` x (|x_hat gamma| + |beta|), the
elements past 1 (their y, their terms and the f64 GroupNorm value), and where kernel
and plain differ how often each is the bf16 tail of the f64 value (no residual). Then
``chip_smoke``'s phases 11 (a) and 13 (a). On a card:

    python scripts/gn_bf16_rounding_torch.py [SUMMARY.json]

It prints as it goes, and writes the per-shape summary to SUMMARY.json where one is
named.
"""
import json
import os
import sys

import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke as cs  # noqa: E402
from multi_view_stereonet_tpu_torch.checkpoint import random_state_dict  # noqa: E402
from multi_view_stereonet_tpu_torch.ops.cuda import build, gn_apply  # noqa: E402

bf16 = torch.bfloat16


def gn64(x32, groups, weight, bias):
    """The GroupNorm of x32 in f64, and |x_hat gamma| + |beta|."""
    x = x32.double()
    N, C = x.shape[:2]
    xr = x.reshape(N, groups, -1)
    mu = xr.mean(-1, keepdim=True)
    var = xr.var(-1, unbiased=False, keepdim=True)
    xh = ((xr - mu) / torch.sqrt(var + gn_apply.EPS)).reshape(x.shape)
    shp = (1, -1) + (1,) * (x.ndim - 2)
    w, b = weight.double().reshape(shp), bias.double().reshape(shp)
    return xh * w + b, (xh * w).abs() + b.abs()


def chain(y):
    """The bf16 tail on an f32 (or f64) GroupNorm value, no residual."""
    o = y.float().to(bf16).float()
    neg = ~(y >= 0)
    return torch.where(neg, (o * 0.2001953125).to(bf16).float(), o)


def main():
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    build.load_libraries("warp", "incremental_chain", "idepthmap_refiner", "gn_apply")
    print(cs.nvidia_smi(), flush=True)
    state = random_state_dict(4)
    weight = state["refiner0.res0.bn1.weight"].to(dev)
    bias = state["refiner0.res0.bn1.bias"].to(dev)
    xbias = state["refiner0.res0.conv1.bias"].to(dev)
    with torch.inference_mode():
        summary = {}
        for shape, residual, what in cs.GN_SHAPES + cs.CONV_GN_SHAPES:
            worst = 0.0
            worst_floor = 0.0
            n_bad = 0
            kernel_exact = plain_exact = 0
            for seed in range(6):
                g = torch.Generator().manual_seed(100 + seed)
                x = (torch.randn(shape, generator=g) * 2 + 0.5).to(dev).to(bf16)
                res = torch.randn(shape, generator=g).to(dev).to(bf16) if residual else None
                got = gn_apply.group_norm_act(x, weight, bias, 4, res, impl="kernel",
                                              xbias=xbias).float()
                ref = gn_apply.group_norm_act(x, weight, bias, 4, res, impl="plain",
                                              xbias=xbias).float()
                x32 = x.float() + xbias.reshape((-1,) + (1,) * (x.ndim - 2))
                y = F.group_norm(x32, 4, weight, bias, gn_apply.EPS)
                y64, terms = gn64(x32, 4, weight, bias)
                ratio = (got - ref).abs() / (cs.bf16_ulp(y) + cs.bf16_ulp(ref))
                floor = 2.0 ** -21 * terms.float()
                ratio_floor = (got - ref).abs() / (cs.bf16_ulp(y) + cs.bf16_ulp(ref) + floor)
                worst = max(worst, ratio.max().item())
                worst_floor = max(worst_floor, ratio_floor.max().item())
                if not residual:
                    exact = chain(y64)
                    off = got != ref
                    kernel_exact += int((got[off] == exact[off]).sum())
                    plain_exact += int((ref[off] == exact[off]).sum())
                bad = ratio > 1
                n_bad += int(bad.sum())
                for i in bad.nonzero()[:4].tolist():
                    i = tuple(i)
                    print(f"  {shape} seed {seed} at {i}: got {got[i].item():.6e} ref "
                          f"{ref[i].item():.6e} |d| {abs(got[i] - ref[i]).item():.3e} ratio "
                          f"{ratio[i].item():.2f}; y32 {y[i].item():.9e} y64 {y64[i].item():.9e} "
                          f"terms {terms[i].item():.3e} floor {floor[i].item():.3e} ulp(y) "
                          f"{cs.bf16_ulp(y)[i].item():.3e}", flush=True)
            summary[str(shape) + (" +res" if residual else "")] = {
                "worst": worst, "worst_with_floor": worst_floor, "elements_over": n_bad,
                "off_elements_where_kernel_is_exact_chain": kernel_exact,
                "off_elements_where_plain_is_exact_chain": plain_exact}
            print(shape, what, summary[str(shape) + (" +res" if residual else "")], flush=True)

        failures = []
        f32 = {k: {"ms": 0.0} for k in ("warp", "chain", "refiner", "gn_apply")}
        cs.check_kernels_bf16(dev, f32, failures)
        print("phase 11 (a) failures:", failures, flush=True)
        failures = []
        cs.check_kernels_tf32(dev, failures)
        print("phase 13 (a) failures:", failures, flush=True)
    if len(sys.argv) > 1:
        with open(sys.argv[1], "w") as f:
            json.dump(summary, f, indent=1)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Run chip_smoke.py's phase-3b check of K3's backward over many draws of its inputs.

    python scripts/k3_check_draws.py [--draws 10] [--out FILE]

Needs an NVIDIA card. At each of phase 3b's K3 shapes ((N, 35, h, w) = (1, 35, 30, 40),
(8, 35, 30, 40), (1, 35, 60, 80), (8, 35, 60, 80), refiner 4 or 3 of
``random_state_dict(4)``) and each draw (guidance, idepth and the output's gradient from
``torch.Generator().manual_seed(draw)``), K3's Function (``refiner.idepthmap_refiner``
on the card) and plain autograd through the module's plain forward give the gradients of
guidance, idepth and the weights, and ``chip_smoke.refiner_legs`` reads them as phase 3b
does. Each line prints the direct gap (the Function against that plain autograd), the
Function against autograd through the kernel's plain forward (``saved_forward``), the
LeakyReLU and ReLU branches that the kernel's forward takes apart from each of those two
forwards, and the readings outside their bars; with ``--out`` every reading is written
as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((1, 30, 40, "refiner4"), (8, 30, 40, "refiner4"), (1, 60, 80, "refiner3"),
          (8, 60, 80, "refiner3"))


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--draws", type=int, default=10)
    parser.add_argument("--out", help="write every draw's readings here as JSON")
    args = parser.parse_args()
    sys.path.insert(0, REPO)
    import torch

    import chip_smoke
    from multi_view_stereonet_tpu_torch.checkpoint import random_state_dict
    from multi_view_stereonet_tpu_torch.ops.cuda import refiner as refiner_op

    if not torch.cuda.is_available():
        raise SystemExit("k3_check_draws: needs an NVIDIA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    state = random_state_dict(4)
    rows = []
    for n, h, w, name in SHAPES:
        module = chip_smoke.refiner_module(state, name, dev)
        params = list(module.parameters())
        for draw in range(args.draws):
            g = torch.Generator().manual_seed(draw)
            guidance = (torch.rand(n, 35, h, w, generator=g) * 2 - 1).to(dev).requires_grad_()
            idepth = (torch.rand(n, h, w, generator=g) * 20).to(dev).requires_grad_()
            cot = torch.randn(n, h, w, generator=g).to(dev)
            inputs = (guidance, idepth, *params)
            got = torch.autograd.grad(
                refiner_op.idepthmap_refiner(module, guidance, idepth, "kernel"), inputs, cot)
            ref = torch.autograd.grad(
                refiner_op.idepthmap_refiner(module, guidance, idepth, "plain"), inputs, cot)
            r = chip_smoke.refiner_legs(module, guidance, idepth, cot, got, ref)
            bar = r["bars"]["direct"]
            # The earlier rule: the direct bar held unless the kernel's forward and
            # saved_forward take branches apart.
            r["missed_by_the_old_rule"] = not (r["direct"] <= bar or r["branch_flips"] > 0)
            row = {"shape": f"({n},35,{h},{w})", "draw": draw,
                   **{k: v for k, v in r.items() if k != "bars"}}
            rows.append(row)
            print(f"{row['shape']} draw {draw}: direct {r['direct']:.3e}, against autograd "
                  f"through saved_forward {r['direct_saved']:.3e} (bar {bar:.0e}); branches "
                  f"apart from saved_forward {r['branch_flips']} (|z| <= "
                  f"{r['flip_max_abs_z']:.2e}), from the module's plain forward "
                  f"{r['module_branch_flips']} (|z| <= {r['module_flip_max_abs_z']:.2e}) of "
                  f"{r['gn_values']}; legs {r['function_vs_closed_form']:.2e} "
                  f"{r['closed_form_vs_autograd']:.2e}; missed {r['missed']}, by the old "
                  f"rule {r['missed_by_the_old_rule']}", flush=True)
    smi = chip_smoke.nvidia_smi()
    summary = {"card": smi, "draws": len(rows),
               "missed": sum(bool(r["missed"]) for r in rows),
               "missed_by_the_old_rule": sum(r["missed_by_the_old_rule"] for r in rows),
               "direct_over_bar": sum(r["direct"] > chip_smoke.BACKWARD_BAR for r in rows),
               "direct_over_bar_without_module_flips": sum(
                   r["direct"] > chip_smoke.BACKWARD_BAR and not r["module_branch_flips"]
                   for r in rows)}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"summary": summary, "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()

"""Hold K1, the grid-sample kernel (csrc/warp.cu), against its plain version at a grid
that holds NaN and +-inf coordinates, on an NVIDIA card.

    python scripts/check_k1_nan.py [ROOT]

ROOT is a checkout of this repository (default: the one holding this script), so an
older commit unpacked with ``git archive`` can be checked beside this one; its kernel
is built from its own sources. The grid is 2 x 6 x 7 over a 16 x 20 image; one row
holds (NaN, 0.1), (0.2, NaN), (NaN, NaN), (NaN, 5), (inf, 0.3), (-inf, -inf). For one
channel and three, with and without ``zero_invalid``, it prints the NaN outputs of
kernel and plain version, what the kernel wrote where the plain version has NaN,
whether the invalid flags and every other output agree bit for bit, and the card's
``nvidia-smi`` name and power limit. Exits 1 if any case disagrees.
"""

from __future__ import annotations

import os
import subprocess
import sys

import torch


def main():
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                           os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
    sys.path.insert(0, root)
    from multi_view_stereonet_tpu_torch.ops.cuda import warp

    if not torch.cuda.is_available():
        raise SystemExit("check_k1_nan: needs an NVIDIA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"checkout {root}; package {os.path.dirname(warp.__file__)}; {smi}")
    dev = torch.device("cuda")
    nan, inf = float("nan"), float("inf")
    ok = True
    for C in (1, 3):
        g = torch.Generator().manual_seed(C)
        image = (torch.rand(2, 16, 20, C, generator=g) * 2 - 1).to(dev)
        grid = torch.rand(2, 6, 7, 2, generator=g) * 2.4 - 1.2
        grid[0, 0, :6] = torch.tensor([[nan, 0.1], [0.2, nan], [nan, nan], [nan, 5.0],
                                       [inf, 0.3], [-inf, -inf]])
        grid = grid.to(dev)
        for zero_invalid in (False, True):
            got, inv = warp.grid_sample(image, grid, zero_invalid, impl="kernel")
            ref, inv_ref = warp.grid_sample(image, grid, zero_invalid, impl="plain")
            where = torch.isnan(ref)
            same_nan = torch.equal(torch.isnan(got), where)
            rest = torch.equal(torch.nan_to_num(got, nan=7.0), torch.nan_to_num(ref, nan=7.0))
            flags = torch.equal(inv, inv_ref)
            print(f"C={C} zero_invalid={zero_invalid}: NaN outputs kernel "
                  f"{int(torch.isnan(got).sum())}, plain {int(where.sum())}; at the same "
                  f"places {same_nan}; the kernel wrote there {got[where].tolist()}; "
                  f"invalid flags equal {flags}; all else bit-equal {rest}")
            ok &= same_nan and rest and flags
    print("agree" if ok else "DISAGREE")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Does the bf16 recipe train alike under the backward kernels of K2 and K3 and under
plain autograd?

K2's backward at bf16 storage (``ops/cuda/incremental_chain.py`` ``_IncrementalChain``)
differentiates the kernel's own bf16 forward, which warps in f32 and rounds once, and keeps
its gradients f32; the JAX package's ``_chain_bwd`` takes ``jax.vjp`` of the scan at bf16,
which warps at bf16 and rounds every gradient to bf16, and so does the port's plain
autograd through ``incremental_chain_plain``. K3's (``ops/cuda/refiner.py``
``_IdepthmapRefiner``) likewise differentiates its kernel's bf16 forward, which keeps each
conv's output f32, with f32 gradients, where plain autograd through the module at bf16
(``idepthmap_refiner_plain``) rounds each conv's output and every gradient to bf16. This
script trains Run A's recipe (the ``layered_track`` tree at 96x128, batch 4, adam 1e-3;
``run_convergence_torch.py``'s) at ``compute_dtype: bfloat16`` from the seed's init,
``CONV_EPOCHS_FIRST`` then resumed to ``CONV_EPOCHS_TOTAL`` epochs (30 and 60 by default):

- ``--runs kernel kernel`` trains it twice as the port trains, through the Functions
  (tags ``kernel_1``, ``kernel_2``): their gap is the card's own spread;
- ``--runs plain`` once with K2's backward taken by plain autograd at bf16 through
  ``incremental_chain_plain`` (tag ``plain_backward``), ``--runs plain_k3`` once with K3's
  taken by plain autograd at bf16 through ``idepthmap_refiner_plain`` (tag
  ``plain_k3_backward``): the forward is still the kernel's, only the gradient changes.

The curves (losses, validation, summary; not the weights) go to ``--dest``
(``docs/convergence_torch/k2_bf16/``), and the last line compares the best validation EPEs:
each plain-backward run lies within the kernel runs' gap plus 5% of their mean, or not.
It replaces a Function of the package by one of its own, so it runs only against a
package whose Functions keep these names and launch signatures.

    python scripts/k2_bf16_convergence_torch.py /tmp/k2bf16 --runs kernel kernel plain
    python scripts/k2_bf16_convergence_torch.py /tmp/k3bf16 --runs kernel kernel plain_k3 \
        --dest docs/convergence_torch/k3_bf16
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from multi_view_stereonet_tpu_torch.ops.cuda import incremental_chain as chain  # noqa: E402
from multi_view_stereonet_tpu_torch.ops.cuda import refiner as refiner_op  # noqa: E402
from multi_view_stereonet_tpu_torch.train.convergence import run_convergence  # noqa: E402

sys.path.insert(0, os.path.join(REPO, "scripts"))
import run_convergence_torch as conv  # noqa: E402

MARGIN = 0.05  # of the kernel runs' mean best EPE


class PlainBackwardChain(torch.autograd.Function):
    """K2's forward kernel, its backward plain autograd through ``incremental_chain_plain``
    at the forward's dtype (the gradient the port took before K2 had a backward kernel)."""

    @staticmethod
    def forward(ctx, refiner, cluster, tf32, feats0, image_rest, H_inc, *params):
        ctx.refiner = refiner
        ctx.save_for_backward(feats0, image_rest, H_inc)
        return chain._launch(refiner, feats0, image_rest, H_inc, cluster, tf32)

    @staticmethod
    def backward(ctx, grad):
        feats0, image_rest, H_inc = ctx.saved_tensors
        needs = ctx.needs_input_grad[3:]
        params = list(ctx.refiner.parameters())
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(bool(need))
                      for t, need in zip((feats0, image_rest, H_inc), needs)]
            out = chain.incremental_chain_plain(ctx.refiner, *leaves)
            wanted = [t for t in leaves + params if t.requires_grad]
            got = iter(torch.autograd.grad(out, wanted, grad, allow_unused=True))
        return (None, None, None,
                *(next(got) if t.requires_grad else None for t in leaves + params))


class PlainBackwardRefiner(torch.autograd.Function):
    """K3's forward kernel, its backward plain autograd through ``idepthmap_refiner_plain``
    at the guidance's dtype (the gradient the port took before K3 had a backward kernel)."""

    @staticmethod
    def forward(ctx, refiner, tf32, guidance, idepthmap, *params):
        ctx.refiner = refiner
        ctx.save_for_backward(guidance, idepthmap)
        return refiner_op._launch(refiner, guidance, idepthmap, tf32)

    @staticmethod
    def backward(ctx, grad):
        guidance, idepthmap = ctx.saved_tensors
        needs = ctx.needs_input_grad[2:]
        params = list(ctx.refiner.parameters())
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(bool(need))
                      for t, need in zip((guidance, idepthmap), needs)]
            out = refiner_op.idepthmap_refiner_plain(ctx.refiner, *leaves)
            wanted = [t for t in leaves + params if t.requires_grad]
            got = iter(torch.autograd.grad(out, wanted, grad, allow_unused=True))
        return (None, None, *(next(got) if t.requires_grad else None for t in leaves + params))


TAGS = {"plain": "plain_backward", "plain_k3": "plain_k3_backward"}


def best_epe(dest: str, tag: str) -> float:
    with open(os.path.join(dest, f"validation_{tag}.txt")) as f:
        rows = [line.split() for line in f if line.strip()]
    col = rows[0].index("epe")
    return min(float(r[col]) for r in rows[1:])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, allow_abbrev=False,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("workdir", nargs="?", default=None)
    ap.add_argument("--runs", nargs="+", choices=("kernel", "plain", "plain_k3"),
                    default=["kernel", "kernel", "plain"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dest", default=os.path.join(REPO, "docs", "convergence_torch",
                                                    "k2_bf16"))
    ns = ap.parse_args(argv)
    work = ns.workdir or os.path.join(tempfile.gettempdir(), "k2_bf16")
    data_dir, split = conv.make_tree(os.path.join(work, "tree"), "layered_track", (96, 128),
                                     2, 10)
    card = conv.card_description(ns.device)
    functions = (chain._IncrementalChain, refiner_op._IdepthmapRefiner)
    kernel_runs = 0
    tags = []
    for run in ns.runs:
        if run == "kernel":
            kernel_runs += 1
            tag = f"kernel_{kernel_runs}"
        else:
            tag = TAGS[run]
        chain._IncrementalChain = PlainBackwardChain if run == "plain" else functions[0]
        refiner_op._IdepthmapRefiner = (PlainBackwardRefiner if run == "plain_k3"
                                        else functions[1])
        how = {"kernel": "K2's and K3's backward kernels",
               "plain": "K2's backward by plain autograd at bf16",
               "plain_k3": "K3's backward by plain autograd at bf16"}[run]
        describe = (f"Run A's recipe at compute_dtype bfloat16 (layered_track tree 96x128, 2 "
                    f"sequences x 10 frames, seed {conv.TREE_SEED}), {how}, on {card} by "
                    f"`python scripts/k2_bf16_convergence_torch.py <work> --runs "
                    f"{' '.join(ns.runs)}`.")
        before = chain.backward_launches, refiner_op.backward_launches
        run_convergence(data_dir, split, os.path.join(work, tag), ns.dest, size=(96, 128),
                        batch=4, epochs_first=conv.EPOCHS_FIRST,
                        epochs_total=conv.EPOCHS_TOTAL, tag=tag, device=ns.device,
                        overrides={"compute_dtype": "bfloat16"}, describe=describe)
        print(f"{tag}: backward kernel launches K2 {chain.backward_launches - before[0]}, K3 "
              f"{refiner_op.backward_launches - before[1]}", flush=True)
        shutil.rmtree(os.path.join(ns.dest, tag), ignore_errors=True)  # the weights
        tags.append(tag)
    chain._IncrementalChain, refiner_op._IdepthmapRefiner = functions
    best = {tag: best_epe(ns.dest, tag) for tag in tags}
    result = {"best_epe": best, "card": card}
    kernel = [v for k, v in best.items() if k.startswith("kernel")]
    plain = [tag for tag in TAGS.values() if tag in best]
    if len(kernel) == 2 and plain:
        margin = MARGIN * sum(kernel) / 2
        low, high = min(kernel) - margin, max(kernel) + margin
        result.update(tolerance=abs(kernel[0] - kernel[1]) + margin, window=[low, high],
                      alike={tag: low <= best[tag] <= high for tag in plain})
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()

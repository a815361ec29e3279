#!/usr/bin/env python3
"""Run A's recipe for its first epochs from several draws of each init, and the table of
their ``refined_zero_frac``.

    python scripts/init_draws_torch.py write DIR [--port-seeds 4 5 6 7] [--jax-keys 4 5 6 7]
    python scripts/init_draws_torch.py run DIR DEST [--epochs 20] [--at-once 4] [--device cuda]
    python scripts/init_draws_torch.py table DEST OUT.md [--epochs 20]

``write`` (on the CPU, where the JAX package is installed) writes one
``<DIR>/<draw>/stereo_network.pth`` a draw: ``port_s<seed>`` the port's init
(``checkpoint/convert.py`` ``init_params_numpy(seed, reference=True)``, what the train CLI
draws at that seed) and ``jax_k<key>`` the JAX package's (``init_mvsnet(PRNGKey(key))``),
both through the port's converter ``state_dict_from_jax_params``.

``run`` trains each draw under ``DIR`` by ``scripts/run_convergence_torch.py
--scene layered_track --init_weights <DIR>/<draw> --tag <draw>`` (Run A: 96x128, batch 4,
adam 1e-3, the tree of seed 7), stopped at half of ``--epochs`` and resumed to
``--epochs`` (``CONV_EPOCHS_FIRST`` / ``CONV_EPOCHS_TOTAL``), ``--at-once`` runs at a time
on the one card, each writing its curves, summary and final weights into ``DEST`` and its
checkpoints under the temp directory. Every draw shares the data order
(the config's seed), so the draws differ by their init alone.

``table`` writes a markdown table of ``refined_zero_frac`` by epoch for every
``validation_<draw>.txt`` in ``DEST`` and the committed seed-3 runs
(``docs/convergence_torch/validation_layered_track.txt``, ``repeat_seed/``,
``repeat_jax_init/``), and per init the draws that relapse: > 0 at an epoch after one
at which it read 0, from epoch 5 on (the seed-3 repeat is the same draw and is not
counted again).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMITTED = {"port_s3": "docs/convergence_torch/validation_layered_track.txt",
             "port_s3 (repeat)": "docs/convergence_torch/repeat_seed/"
                                 "validation_layered_track.txt",
             "jax_k3": "docs/convergence_torch/repeat_jax_init/validation_layered_track.txt"}


def write(out: str, port_seeds, jax_keys) -> None:
    sys.path.insert(0, REPO)
    import jax
    import numpy as np
    import torch

    from multi_view_stereonet_tpu.models.mvsnet import init_mvsnet
    from multi_view_stereonet_tpu_torch.checkpoint.convert import (
        init_params_numpy, state_dict_from_jax_params)

    draws = {f"port_s{s}": init_params_numpy(s, reference=True) for s in port_seeds}
    draws.update({f"jax_k{k}": jax.tree_util.tree_map(
        np.asarray, init_mvsnet(jax.random.PRNGKey(k))) for k in jax_keys})
    for name, params in draws.items():
        os.makedirs(os.path.join(out, name), exist_ok=True)
        torch.save(state_dict_from_jax_params(params),
                   os.path.join(out, name, "stereo_network.pth"))
        print(f"wrote {out}/{name}/stereo_network.pth", flush=True)


def run(inits: str, dest: str, epochs: int, at_once: int, device: str) -> None:
    draws = sorted(d for d in os.listdir(inits)
                   if os.path.exists(os.path.join(inits, d, "stereo_network.pth")))
    env = dict(os.environ, CONV_EPOCHS_FIRST=str(epochs // 2), CONV_EPOCHS_TOTAL=str(epochs))
    failed = []
    for start in range(0, len(draws), at_once):
        procs = []
        for draw in draws[start:start + at_once]:
            log = open(os.path.join(dest, f"log_{draw}.txt"), "w")
            cmd = [sys.executable, os.path.join(REPO, "scripts", "run_convergence_torch.py"),
                   os.path.join(tempfile.gettempdir(), f"init_draw_{draw}"),
                   "--scene", "layered_track",
                   "--init_weights", os.path.join(inits, draw), "--tag", draw,
                   "--dest", dest, "--device", device]
            procs.append((draw, subprocess.Popen(cmd, env=env, stdout=log,
                                                 stderr=subprocess.STDOUT), log))
        for draw, proc, log in procs:
            if proc.wait() != 0:
                failed.append(draw)
            log.close()
            print(f"{draw}: exit {proc.returncode}", flush=True)
    if failed:
        raise SystemExit(f"failed: {failed}")


def zero_frac(path: str, epochs: int) -> list:
    with open(path) as f:
        rows = [line.split() for line in f if line.strip()]
    col = rows[0].index("refined_zero_frac")
    return [float(r[col]) for r in rows[1:epochs + 1]]


def relapses(fracs: list) -> list:
    """Epochs from 5 on that read > 0 after an epoch that read 0."""
    seen_zero, out = False, []
    for epoch, f in enumerate(fracs):
        if f == 0.0:
            seen_zero = True
        elif seen_zero and epoch >= 5:
            out.append(epoch)
    return out


def table(dest: str, out: str, epochs: int) -> None:
    runs = {name: os.path.join(REPO, path) for name, path in COMMITTED.items()}
    runs.update({f[len("validation_"):-len(".txt")]: os.path.join(dest, f)
                 for f in sorted(os.listdir(dest))
                 if f.startswith("validation_") and f.endswith(".txt")})
    fracs = {name: zero_frac(path, epochs) for name, path in runs.items()}
    lines = ["| epoch | " + " | ".join(fracs) + " |",
             "| --- | " + " | ".join("---" for _ in fracs) + " |"]
    for e in range(epochs):
        lines.append(f"| {e} | " + " | ".join(
            f"{v[e]:.4f}" if e < len(v) else "" for v in fracs.values()) + " |")
    lines.append("")
    for init in ("port", "jax"):
        mine = {n: relapses(v) for n, v in fracs.items()
                if n.startswith(init) and "repeat" not in n}
        hit = {n: r for n, r in mine.items() if r}
        lines.append(f"- {init} init: {len(hit)} of {len(mine)} draws relapse "
                     f"({', '.join(f'{n} at epochs {r}' for n, r in hit.items()) or 'none'}).")
    with open(out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print("\n".join(lines))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    w = sub.add_parser("write")
    w.add_argument("out")
    w.add_argument("--port-seeds", type=int, nargs="+", default=[4, 5, 6, 7])
    w.add_argument("--jax-keys", type=int, nargs="+", default=[4, 5, 6, 7])
    r = sub.add_parser("run")
    r.add_argument("inits")
    r.add_argument("dest")
    r.add_argument("--epochs", type=int, default=20)
    r.add_argument("--at-once", type=int, default=4)
    r.add_argument("--device", default="cuda")
    t = sub.add_parser("table")
    t.add_argument("dest")
    t.add_argument("out")
    t.add_argument("--epochs", type=int, default=20)
    args = ap.parse_args()
    if args.cmd == "write":
        write(args.out, args.port_seeds, args.jax_keys)
    elif args.cmd == "run":
        os.makedirs(args.dest, exist_ok=True)
        run(args.inits, args.dest, args.epochs, args.at_once, args.device)
    else:
        table(args.dest, args.out, args.epochs)


if __name__ == "__main__":
    main()

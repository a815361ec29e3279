"""Worker processes for the port's multi-process tests (``tests/test_torch_distributed.py``
on the CPU, ``tests/test_torch_cuda.py`` on the card).

Not a test module. ``start`` and ``wait`` run in the test: they start N copies of this
script, each one process of a ``torch.distributed`` group over gloo, wired by the
port's ``parallel.initialize``, and collect them within a time limit. The script
imports the port and nothing of JAX.

Usage: python tests/_torch_distributed_worker.py <job.json> <process_id> <num_processes>
                                                  <port>

The job is a JSON object with ``mode``:
- "step": on ``device`` ("cpu" by default; "cuda": every process on the card), for
  each of ``cases`` (``weights``: a state dict saved with torch.save; ``batch``: the
  GLOBAL batch as an .npz; ``mesh_view``; ``two_view``; ``D``; ``factors``; ``dtype``,
  the compute dtype, "float32" where absent), this
  rank's data shard of the batch (samples in rank order, as the JAX package's
  ``global_batch`` concatenates them) and its views go through one ``make_train_step``
  (sgd at rate 0, so the weights stay and ``.grad`` holds the averaged gradient);
  then, without a view axis, the same loss without the mesh on the shard alone (the
  per-rank loss that plain data parallelism would average). Saves
  ``<out>/<case>_rank<r>.npz``: loss, local_loss, the loss dict's entries and every
  gradient.
- "cli": ``train_cli.main(argv)`` on the CPU, with ``poison_rank`` (optional): that
  rank's training batches from the second on hold NaN images; and ``record``
  (optional): a directory where ``record_training`` writes what each step trained on.
"""

import contextlib
import hashlib
import json
import os
import socket
import subprocess
import sys
import threading

import numpy as np
import torch

TIMEOUT = 240  # seconds for all processes of one job


def start(job: dict, tmp, name: str, n: int = 2) -> list:
    """Start ``n`` worker processes on ``job`` (written to ``<tmp>/<name>.json``)."""
    path = os.path.join(tmp, f"{name}.json")
    with open(path, "w") as f:
        json.dump(job, f)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    return [subprocess.Popen([sys.executable, os.path.abspath(__file__), path, str(i), str(n),
                              str(port)], env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True) for i in range(n)]


def wait(procs, timeout: float = TIMEOUT) -> list:
    """[(returncode, stdout, stderr)] of each process; all are killed at the limit."""
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            results.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return results


def run_steps(job, pid):
    from multi_view_stereonet_tpu_torch.losses import LossConfig
    from multi_view_stereonet_tpu_torch.models import (
        MultiViewStereoNet, MultiViewStereoNetConfig)
    from multi_view_stereonet_tpu_torch.parallel import make_process_mesh
    from multi_view_stereonet_tpu_torch.train import step

    device = torch.device(job.get("device", "cpu"))
    for name, case in job["cases"].items():
        model = MultiViewStereoNet()
        model.load_state_dict(torch.load(case["weights"], weights_only=True))
        model = model.to(device)
        mesh = make_process_mesh(view=case["mesh_view"])
        batch = dict(np.load(case["batch"]))
        n = mesh.local_batch_size(len(batch["K"]))
        lo = mesh.data_index * n
        shard = mesh.shard_batch({k: v[lo:lo + n] for k, v in batch.items()})
        shard = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                 for k, v in shard.items()}
        config = MultiViewStereoNetConfig(num_idepth_samples=case["D"],
                                          compute_dtype=case.get("dtype", "float32"))
        loss_config = LossConfig(**case["factors"])
        kw = dict(multi_view=not case["two_view"], estimate_right_idepthmap=case["two_view"])
        optimizer = step.make_optimizer(step.OptimizerConfig(optimizer="sgd",
                                                             learning_rate=0.0),
                                        model.parameters())
        train_step = step.make_train_step(config, loss_config, optimizer, mesh=mesh, **kw)
        loss, loss_dict = train_step(model, shard)
        out = {"loss": loss.cpu().numpy()}
        for k, v in loss_dict.items():
            out[f"dict/{k}"] = np.array([x.item() for x in v] if isinstance(v, list)
                                        else v.item())
        for k, p in model.named_parameters():
            out[f"grad/{k}"] = p.grad.cpu().numpy()
        if mesh.view == 1:
            with torch.no_grad():
                out["local_loss"] = step.make_loss_fn(config, loss_config, **kw)(
                    model, shard)[0].cpu().numpy()
        np.savez(os.path.join(job["out"], f"{name}_rank{pid}.npz"), **out)


def digest(x) -> str:
    """SHA-256 of an array's or a tensor's dtype, shape and bytes."""
    x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    x = np.ascontiguousarray(x)
    return hashlib.sha256(f"{x.dtype} {x.shape} ".encode() + x.tobytes()).hexdigest()


class _Counting:
    """A dataset that counts the samples taken from it (from any thread)."""

    def __init__(self, dataset):
        self.dataset, self.taken, self._lock = dataset, 0, threading.Lock()

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx):
        with self._lock:
            self.taken += 1
        return self.dataset[idx]


@contextlib.contextmanager
def record_training(train_cli, out, rank):
    """Within it, ``train_cli.train`` records, at each step k counted from 0 in this
    process: the SHA-256 of each tensor the step trains on (``digest``); on rank 0, the
    weights entering the step, the gradient it applies (after the all-reduce) and its
    loss (``<out>/step<k>.pt``); and on a rank that loaded the step's batch (every rank
    at ``mesh_view`` 1, a view group's leader otherwise), that batch without its
    filenames (``<out>/loaded<k>_rank<r>.npz``). On leaving, it writes
    ``<out>/rank<r>.json``: the digests by step and the samples this rank's loader
    decoded; and restores ``train_cli``."""
    build, feed_class = train_cli.build_train_step, train_cli.ViewGroupFeed
    digests, datasets = [], []

    def recording_build(*args, **kwargs):
        built = build(*args, **kwargs)
        step = built[3]

        def recording_step(model, batch):
            k = len(digests)
            digests.append({key: digest(v) for key, v in batch.items()})
            weights = {key: v.detach().cpu().clone() for key, v in model.state_dict().items()}
            loss, loss_dict = step(model, batch)
            if rank == 0:
                torch.save({"weights": weights, "loss": loss.item(),
                            "grads": {key: p.grad.detach().cpu().clone()
                                      for key, p in model.named_parameters()}},
                           os.path.join(out, f"step{k}.pt"))
            return loss, loss_dict
        return (*built[:3], recording_step)

    class RecordingFeed(feed_class):
        def __init__(self, mesh, loader, device):
            loader.dataset = _Counting(loader.dataset)
            datasets.append(loader.dataset)
            super().__init__(mesh, loader, device)

        def __iter__(self):
            for batch, tensors in super().__iter__():
                if batch is not None:
                    np.savez(os.path.join(out, f"loaded{len(digests)}_rank{rank}.npz"),
                             **{key: v for key, v in batch.items()
                                if not key.endswith("filenames")})
                yield batch, tensors

    os.makedirs(out, exist_ok=True)
    train_cli.build_train_step, train_cli.ViewGroupFeed = recording_build, RecordingFeed
    try:
        yield
    finally:
        train_cli.build_train_step, train_cli.ViewGroupFeed = build, feed_class
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump({"digests": digests, "decoded": sum(d.taken for d in datasets)}, f)


def run_cli(job, pid):
    from multi_view_stereonet_tpu_torch.train import train_cli

    if job.get("poison_rank") == pid:
        class PoisonedLoader(train_cli.BatchLoader):
            def __iter__(self):
                for i, batch in enumerate(super().__iter__()):
                    if self.shuffle and i >= 1:
                        batch = dict(batch,
                                     left_image=np.full_like(batch["left_image"], np.nan))
                    yield batch

        train_cli.BatchLoader = PoisonedLoader
    with (record_training(train_cli, job["record"], pid) if job.get("record")
          else contextlib.nullcontext()):
        train_cli.main(job["argv"])


def main():
    job_file, pid, nproc, port = sys.argv[1:5]
    pid, nproc = int(pid), int(nproc)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    torch.set_num_threads(2)
    with open(job_file) as f:
        job = json.load(f)
    if job["mode"] == "cli":
        run_cli(dict(job, argv=job["argv"] + [
            "--coordinator", f"localhost:{port}", "--num_processes", str(nproc),
            "--process_id", str(pid), "--device", "cpu"]), pid)
        return
    from multi_view_stereonet_tpu_torch.parallel import initialize, shutdown

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if not initialize(f"localhost:{port}", nproc, pid, device=job.get("device", "cpu")):
        raise SystemExit("initialize() joined no process group")
    try:
        run_steps(job, pid)
    finally:
        shutdown()
    print("RESULT ok", flush=True)


if __name__ == "__main__":
    main()

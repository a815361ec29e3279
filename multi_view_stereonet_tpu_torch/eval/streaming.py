"""Batched streaming inference, each batch split by samples over the devices.

Port of ``multi_view_stereonet_tpu/eval/streaming.py``. The JAX runner shards each batch
over the ``data`` axis of a mesh of every device (``make_mesh``) and replicates a batch
that does not divide by the device count; here ``StreamingRunner`` keeps one replica of
the model a device (every card the process sees by default) and serves rows
``[i*b/n, (i+1)*b/n)`` of a batch of b on replica i of n, or the whole batch on replica
0 where n does not divide b (the trailing partial batch): the JAX devices compute such
a batch whole, each the same, so replica 0 alone computes what they compute. Fleet
sharding across processes is ``--shard_id/--num_shards``.

A host-side loader thread keeps decoded batches ahead. One host thread dispatches every
replica in turn, as the JAX runner's one host loop does: each replica's rows are copied
to its card from pinned host memory without blocking, its forward is queued, and its
output is copied back into its rows of one of a ring of ``IN_FLIGHT + 1`` pinned host
buffers; two steps stay in flight, so decode, the host-to-device copies, the forwards
and the readbacks of consecutive batches overlap. ``run`` yields numpy arrays of their
own (copies out of the ring), so a caller may keep them: the page-locked memory stays
the ring's.

The transport follows the dataset's image dtype. A dataset that emits uint8
pixels (``make_dataset(..., u8_output=True)``, the CLI's ``--transfer_u8``)
ships 4x fewer bytes, dequantized on the card bit-exactly
(``ops/quantize.py``): outputs are bit-identical to the float32 transport.
``fetch_dtype`` (e.g. ``torch.float16``) casts the output on the card before
the readback.

Usage (library):
    runner = StreamingRunner(model, MultiViewStereoNetConfig())  # every card
    for idepthmaps, names in runner.run(dataset, batch_size=8):
        ...  # idepthmaps: (B, H, W) numpy array

CLI (weights: ``<weights_dir>/stereo_network.pth``, the port's state dict, or the JAX
package's ``stereo_network.msgpack``, or the reference's TorchScript
``stereo_network.pt``, the first found (``checkpoint/native.py`` ``load_any_params``);
params: ``--params_yaml`` or ``<weights_dir>/../../params.yaml``):
    python -m multi_view_stereonet_tpu_torch.eval.streaming \
        <weights_dir> <data_dir> <split> [--batch_size 8] [--transfer_u8] \
        [--fetch_f16] [--bf16] [--shard_id I --num_shards N] [--device cuda:0 | cpu]

``--device cuda`` (the default) serves on every card the process sees, ``cuda:<i>`` on
that card alone, ``cpu`` on the CPU; the last line names the devices that served.

The forward's dtype comes from ``--bf16`` alone (``compute_dtype`` bfloat16, else
float32), as the JAX CLI sets it: the CLI reads no dtype key of params.yaml, and no
``matmul_precision`` either (the JAX CLI reads none), so it serves at "default", exact
f32. The precision comes from the config, whatever the caller's TF32 flags: the
forward sets them stage by stage and restores the caller's (``models/mvsnet.py``
``resolve_precision``), so a ``StreamingRunner`` built from Python computes what the
CLI computes. ``main`` also keeps them off (``torch.backends.cudnn.allow_tf32`` and
``torch.backends.cuda.matmul.allow_tf32`` False).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import dataclasses
import os
import time
from typing import NamedTuple

import torch

from ..checkpoint.native import PARAMS_FILE as WEIGHTS_FILE, load_any_params
from ..data import BatchLoader, DeMoNDataset, GTASfMMultiViewDataset, get_testing_transforms
from ..models import (
    MultiViewStereoNet, MultiViewStereoNetConfig, mvsnet_forward, resolve_precision)
from ..ops.quantize import dequantize_images_u8
from ..parallel import ShardedDataset
from ..train.config import load_params_yaml
from ..train.pipeline import multi_view_unpack_batch

MODEL_KEYS = ("left_image", "right_images", "K", "T_right_in_left")
IMAGE_KEYS = ("left_image", "right_images")
IN_FLIGHT = 2  # steps queued on the device ahead of the readback the caller waits on


def serving_forward(model, batch, config: MultiViewStereoNetConfig, impl: str = "auto",
                    fetch_dtype=None):
    """The serving computation: metric batch -> metric inverse depth (B, H, W).

    Images are float32, or uint8 (the serving transport), which are dequantized on
    the tensors' device bit-exactly. ``fetch_dtype`` casts the output before readback
    (half the device-to-host bytes at float16)."""
    batch = dict(batch)
    for key in IMAGE_KEYS:
        if batch[key].dtype == torch.uint8:
            batch[key] = dequantize_images_u8(batch[key])
        elif batch[key].dtype != torch.float32:
            raise TypeError(f"{key} must be float32 or uint8 images, got {batch[key].dtype}")
    inputs = multi_view_unpack_batch(batch, config.num_levels)
    out = mvsnet_forward(model, inputs["left_image_pyr"], inputs["K_pyr"],
                         inputs["T_right_in_left"], inputs["right_image_pyr"], config,
                         impl)
    idepth = out["left_idepthmap_pyr"][0] / inputs["baseline"][:, None, None]
    return idepth if fetch_dtype is None else idepth.to(fetch_dtype)


def to_device(arrays: dict, device: torch.device) -> dict:
    """Numpy arrays -> tensors on ``device``. To a card: staged in pinned host memory
    and copied without blocking the host, on the current stream, so the work queued
    after reads them in order. PyTorch's pinned-memory allocator records the copy and
    reuses a staging buffer only after the copy that reads it has completed."""
    tensors = {k: torch.as_tensor(v) for k, v in arrays.items()}
    if device.type != "cuda":
        return tensors
    return {k: t.pin_memory().to(device, non_blocking=True) for k, t in tensors.items()}


def serving_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless ``device`` names another. A
    card that this process does not have raises; nothing falls back to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("this runs on a CUDA card and the process has none: pass "
                           "device='cpu' to run on the CPU")
    return device


class ReadbackRing:
    """``slots`` host buffers taken in turn by step: step k writes slot k % slots, and
    holds it until step k + slots. A slot is reallocated only when the output's shape
    or dtype changes (the trailing partial batch). Pinned when ``pin_memory``."""

    def __init__(self, slots: int, pin_memory: bool):
        self._slots = [None] * slots
        self._pin_memory = pin_memory

    def take(self, step: int, shape, dtype) -> torch.Tensor:
        i = step % len(self._slots)
        buf = self._slots[i]
        if buf is None or buf.shape != shape or buf.dtype != dtype:
            buf = torch.empty(shape, dtype=dtype, pin_memory=self._pin_memory)
            self._slots[i] = buf
        return buf


class Replica(NamedTuple):
    """One copy of the served model: its device, and the stream its work is queued on
    (None: the device's current stream)."""
    model: MultiViewStereoNet
    device: torch.device
    stream: "torch.cuda.Stream | None"


def serving_devices(device=None, devices=None) -> tuple:
    """The devices a runner serves on, one replica each: ``device`` alone, or each of
    ``devices`` in order, or (neither given) every card the process sees, as the JAX
    runner's default mesh takes every device. No card raises (``serving_device``); so do
    both arguments given and an empty ``devices``."""
    if device is not None and devices is not None:
        raise ValueError("pass device or devices, not both")
    if devices is None:
        if device is not None:
            return (serving_device(device),)
        serving_device()  # raises where the process has no card
        return tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))
    devices = tuple(serving_device(d) for d in devices)
    if not devices:
        raise ValueError("devices is empty: name at least one device")
    return devices


class StreamingRunner:
    """Serves one model over one or more devices, one replica a device: ``device`` alone,
    or each of ``devices`` in order, or every card the process sees (neither given). The
    model, config, devices, impl and fetch dtype are fixed at construction and read-only:
    build a new runner to change them.

    Replica 0 is the caller's model, moved to the first device; the others are copies of
    it, built outside ``torch.inference_mode`` as ``load_model`` builds its model (K3's
    weight pack is keyed on each parameter's version counter) and each packed for K3 on
    its own. A device named twice holds two replicas: that drives the split on a host
    with one card, as ``--xla_force_host_platform_device_count`` gives the JAX runner
    several devices on one host (``tests/conftest.py``).

    With more than one replica, each replica's work on a card is queued on a stream of
    its own, made here: its host-to-device copy, its forward and its readback, and the
    event the readback is waited on. Each stream first waits for what the host thread's
    current stream holds on that card. K3's grid-barrier counter is kept per (card,
    stream), so two replicas on one card never share one; their K3 grids, cooperative
    launches of up to one block a SM, run one at a time (a cooperative grid starts once
    every block of it is resident; ``chip_smoke.py`` phase 14 (a)), so neither waits at a
    grid barrier for SMs the other holds. One host thread dispatches
    every replica in turn: the precision scope (``ops/precision.py``), the kernels'
    launch counters and K3's occupancy cache are the process's, not a thread's.

    Replicas compute what one model computes on their rows. Bit for bit where their
    forwards see the batches one replica's would: K3 serves a refiner only at n <= 8
    (``ops/cuda/refiner.py`` ``fused_refiner_supported``), so a batch of 16 on one replica
    runs refiners 4 and 3 as modules and split over two runs both through K3, which agrees
    with the modules within the kernel's bar, not bit for bit."""

    def __init__(self, model: MultiViewStereoNet, model_config: MultiViewStereoNetConfig,
                 device=None, impl: str = "auto", fetch_dtype=None, *, devices=None):
        devices = serving_devices(device, devices)
        streams = len(devices) > 1
        replicas = []
        with torch.inference_mode(False):
            for i, d in enumerate(devices):
                served = (model if i == 0 else copy.deepcopy(replicas[0].model)).to(d).eval()
                stream = torch.cuda.Stream(d) if streams and d.type == "cuda" else None
                replicas.append(Replica(served, d, stream))
        self._replicas = tuple(replicas)
        self._model_config = model_config
        self._impl = impl
        self._fetch_dtype = fetch_dtype

    @property
    def model(self):
        return self._replicas[0].model

    @property
    def model_config(self):
        return self._model_config

    @property
    def device(self):
        return self._replicas[0].device

    @property
    def devices(self) -> tuple:
        return tuple(r.device for r in self._replicas)

    @property
    def impl(self):
        return self._impl

    @property
    def fetch_dtype(self):
        return self._fetch_dtype

    def _shares(self, n: int) -> list:
        """(replica index, rows) of a batch of ``n`` samples, as the JAX runner splits it:
        an equal run of rows a replica where the replicas divide ``n``, else every row on
        replica 0."""
        k = len(self._replicas)
        if k > 1 and n % k == 0:
            b = n // k
            return [(i, slice(i * b, (i + 1) * b)) for i in range(k)]
        return [(0, slice(0, n))]

    def forward(self, batch: dict):
        """One batch (numpy arrays under MODEL_KEYS; float32 or uint8 images), queued.
        One replica: its (B, H, W) output on the device. Several: a list of the outputs
        of the replicas that served it, in sample order (one entry for a batch served
        whole by replica 0), each on its replica's device and queued on its stream;
        synchronize that stream before reading one from another."""
        outs = [out for _, _, out in self._dispatch(batch)]
        return outs[0] if len(self._replicas) == 1 else outs

    def _dispatch(self, batch: dict) -> list:
        """Queue each replica's share of ``batch``: [(replica, rows, output)]."""
        arrays = {k: batch[k] for k in MODEL_KEYS}
        shares = self._shares(len(arrays["left_image"]))
        queued = []
        for i, rows in shares:
            replica = self._replicas[i]
            share = arrays if len(shares) == 1 else {k: v[rows] for k, v in arrays.items()}
            with _on(replica), torch.inference_mode():
                out = serving_forward(replica.model, to_device(share, replica.device),
                                      self._model_config, self._impl, self._fetch_dtype)
            queued.append((replica, rows, out))
        return queued

    def _readback(self, queued: list, ring: ReadbackRing, step: int):
        """Queue the copy of each replica's output into its rows of the ring's slot for
        ``step``: (host tensor, the events recorded after the copies, none on the CPU)."""
        outs = [out for _, _, out in queued]
        host = ring.take(step, (sum(len(o) for o in outs), *outs[0].shape[1:]),
                         outs[0].dtype)
        events = []
        for replica, rows, out in queued:
            with _on(replica, wait=False):
                host[rows].copy_(out, non_blocking=True)
                if replica.device.type == "cuda":
                    done = torch.cuda.Event()
                    done.record(torch.cuda.current_stream(replica.device))
                    events.append(done)
        return host, events

    def run(self, dataset, batch_size=8, prefetch=4, workers=4):
        """Yields (idepthmaps (B, H, W) np.ndarray, left filenames), in sample order.

        The loader stays ``prefetch`` batches ahead with ``workers`` decode threads.
        Device work and the copies are queued without blocking; a step's output is
        yielded once ``IN_FLIGHT`` later steps are queued behind it (or the data ends),
        after every event recorded behind its readbacks has completed, as a copy: its
        ring slot is written again ``IN_FLIGHT + 1`` steps later.
        """
        loader = BatchLoader(dataset, batch_size, shuffle=False, prefetch=prefetch,
                             drop_last=False, workers=workers)
        ring = ReadbackRing(IN_FLIGHT + 1,
                            pin_memory=any(d.type == "cuda" for d in self.devices))
        pending = collections.deque()
        for step, batch in enumerate(loader):
            pending.append((*self._readback(self._dispatch(batch), ring, step),
                            batch["left_filenames"]))
            if len(pending) > IN_FLIGHT:
                yield _host_result(*pending.popleft())
        while pending:
            yield _host_result(*pending.popleft())


def _on(replica: Replica, wait: bool = True):
    """The context that queues work on ``replica``'s stream (after what the current
    stream of its card holds, where ``wait``), or nothing where it has none."""
    if replica.stream is None:
        return contextlib.nullcontext()
    if wait:
        replica.stream.wait_stream(torch.cuda.current_stream(replica.device))
    return torch.cuda.stream(replica.stream)


def _host_result(host: torch.Tensor, events, names):
    for done in events:
        done.synchronize()
    return host.numpy().copy(), names


def load_model(weights_dir: str, device) -> MultiViewStereoNet:
    """The port's network with the weights of ``weights_dir`` loaded (``stereo_network.pth``,
    ``.msgpack`` or ``.pt``: ``load_any_params``), built outside inference mode so that
    its parameters keep version counters (the refiner kernel's weight pack is keyed on
    them)."""
    model = MultiViewStereoNet()
    model.load_state_dict(load_any_params(weights_dir))
    return model.to(device).eval()


def model_config_from_params(cfg: dict) -> MultiViewStereoNetConfig:
    """The forward's knobs from a loaded params.yaml (``load_params_yaml``) as the JAX
    eval CLI reads them (``multi_view_stereonet_tpu/eval/test_cli.py:121-128``): the
    shapes, ``compute_dtype`` (float32 where the file has none) and
    ``matmul_precision`` ("default" where it has none); ``refiner_dtype`` and
    ``frontend_dtype`` stay "auto", which follows compute_dtype. A precision name that
    ``resolve_precision`` does not know raises ValueError, as the JAX forward raises
    for it."""
    config = MultiViewStereoNetConfig(
        num_idepth_samples=cfg["num_idepth_samples"],
        do_cost_volume_filter=cfg["cost_volume_filter"],
        do_refiners=tuple(cfg["refiners"]),
        num_levels=cfg["num_levels"],
        compute_dtype=cfg.get("compute_dtype", "float32"),
        matmul_precision=cfg.get("matmul_precision", "default"),
    )
    resolve_precision(config)
    return config


def make_dataset(data_dir: str, split: str, cfg: dict, decode_backend: str = "auto",
                 u8_output: bool = False):
    """The test dataset of a GTA-SfM or DeMoN split, with the testing transforms;
    ``u8_output`` keeps the images uint8 straight from the decoder (the u8 transport)."""
    transforms = get_testing_transforms(cfg, u8_output=u8_output)
    if "gta_sfm" in split:
        return GTASfMMultiViewDataset(data_dir, split, 0, transforms,
                                      decode_backend=decode_backend)
    if "demon" in split:
        return DeMoNDataset(data_dir, split, num_right_images=1, transform=transforms,
                            decode_backend=decode_backend, load_groundtruth_depthmaps=False)
    raise ValueError(f"cannot infer dataset type from split {split!r} "
                     "(expected a gta_sfm or DeMoN split name)")


def main(argv=None):
    parser = argparse.ArgumentParser(description="Batched streaming inference (PyTorch).")
    parser.add_argument("weights_dir", help="a directory holding stereo_network.pth, "
                        ".msgpack or .pt (the first found)")
    parser.add_argument("data_dir")
    parser.add_argument("test_split")
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--bf16", action="store_true",
                        help="compute_dtype bfloat16 (else float32, whatever params.yaml "
                             "says)")
    parser.add_argument("--fetch_f16", action="store_true",
                        help="cast idepthmaps to float16 on the device before readback "
                             "(halves device-to-host bytes)")
    parser.add_argument("--transfer_u8", action="store_true",
                        help="decode images to uint8 and normalize them on the device "
                             "(4x fewer host-to-device bytes; outputs unchanged)")
    parser.add_argument("--workers", type=int, default=4,
                        help="parallel sample-decode threads")
    parser.add_argument("--params_yaml", default=None)
    parser.add_argument("--decode_backend", default="auto",
                        choices=["auto", "native", "pil"])
    # Fleet sharding: inference has no collectives, so a serving fleet is N
    # independent processes, each taking a strided shard of the split.
    parser.add_argument("--shard_id", type=int, default=0)
    parser.add_argument("--num_shards", type=int, default=1)
    parser.add_argument("--device", default="cuda",
                        help="cuda: every card the process sees, each batch split over "
                             "them by samples; cuda:<i>: that card; cpu")
    args = parser.parse_args(argv)
    if not 0 <= args.shard_id < args.num_shards:
        parser.error(f"--shard_id {args.shard_id} must be in "
                     f"[0, --num_shards {args.num_shards})")

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    params_file = args.params_yaml or os.path.join(args.weights_dir, "..", "..",
                                                   "params.yaml")
    cfg = load_params_yaml(params_file)
    dataset = make_dataset(args.data_dir, args.test_split, cfg, args.decode_backend,
                           u8_output=args.transfer_u8)
    if args.num_shards > 1:
        # Every sample: the shards run no collective, so none need equal lengths.
        dataset = ShardedDataset(dataset, args.shard_id, args.num_shards,
                                 drop_ragged_tail=False)
    # "cuda" is every card, as the JAX CLI's runner takes every device; "cuda:<i>" one.
    devices = serving_devices(devices=None if args.device == "cuda" else [args.device])
    model_config = dataclasses.replace(model_config_from_params(cfg),
                                       compute_dtype="bfloat16" if args.bf16 else "float32",
                                       matmul_precision="default")
    runner = StreamingRunner(load_model(args.weights_dir, devices[0]), model_config,
                             devices=devices,
                             fetch_dtype=torch.float16 if args.fetch_f16 else None)

    t0 = time.perf_counter()
    count = 0
    for idepths, names in runner.run(dataset, args.batch_size, workers=args.workers):
        count += len(names)
    dt = time.perf_counter() - t0
    print(f"{count} depthmaps in {dt:.2f}s -> {count / dt:.1f} depthmaps/sec on "
          f"{describe_devices(devices)}, read back to the host")


def describe_devices(devices) -> str:
    """'2 × NVIDIA H100 80GB HBM3': the count and each kind of device."""
    names = [torch.cuda.get_device_name(d) if d.type == "cuda" else d.type for d in devices]
    return ", ".join(f"{names.count(n)} × {n}" for n in dict.fromkeys(names))

if __name__ == "__main__":
    main()

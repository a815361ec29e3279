"""Batched streaming inference on one device.

Port of ``multi_view_stereonet_tpu/eval/streaming.py`` for one device (the
mesh is not ported; fleet sharding is ``--shard_id/--num_shards``). A
host-side loader thread keeps decoded batches ahead. Each batch is copied to
the card from pinned host memory without blocking, the forward is queued,
and its output is copied back into one of a ring of ``IN_FLIGHT + 1`` pinned
host buffers; two steps stay in flight, so decode, the host-to-device copy,
the forward and the readback of consecutive batches overlap. ``run`` yields
numpy arrays of their own (copies out of the ring), so a caller may keep
them: the page-locked memory stays the ring's.

The transport follows the dataset's image dtype. A dataset that emits uint8
pixels (``make_dataset(..., u8_output=True)``, the CLI's ``--transfer_u8``)
ships 4x fewer bytes, dequantized on the card bit-exactly
(``ops/quantize.py``): outputs are bit-identical to the float32 transport.
``fetch_dtype`` (e.g. ``torch.float16``) casts the output on the card before
the readback.

Usage (library):
    runner = StreamingRunner(model, MultiViewStereoNetConfig())  # on the card
    for idepthmaps, names in runner.run(dataset, batch_size=1):
        ...  # idepthmaps: (B, H, W) numpy array

CLI (weights: ``<weights_dir>/stereo_network.pth``, the port's state dict, or the JAX
package's ``stereo_network.msgpack``, or the reference's TorchScript
``stereo_network.pt``, the first found (``checkpoint/native.py`` ``load_any_params``);
params: ``--params_yaml`` or ``<weights_dir>/../../params.yaml``):
    python -m multi_view_stereonet_tpu_torch.eval.streaming \
        <weights_dir> <data_dir> <split> [--batch_size 8] [--transfer_u8] \
        [--fetch_f16] [--bf16] [--shard_id I --num_shards N] [--device cpu]

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
import dataclasses
import os
import time

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


class StreamingRunner:
    """Serves one model on one device: the card unless ``device`` names another. The
    model, config, device, impl and fetch dtype are fixed at construction and
    read-only: build a new runner to change them."""

    def __init__(self, model: MultiViewStereoNet, model_config: MultiViewStereoNetConfig,
                 device=None, impl: str = "auto", fetch_dtype=None):
        self._device = serving_device(device)
        self._model = model.to(self._device).eval()
        self._model_config = model_config
        self._impl = impl
        self._fetch_dtype = fetch_dtype

    @property
    def model(self):
        return self._model

    @property
    def model_config(self):
        return self._model_config

    @property
    def device(self):
        return self._device

    @property
    def impl(self):
        return self._impl

    @property
    def fetch_dtype(self):
        return self._fetch_dtype

    def forward(self, batch: dict) -> torch.Tensor:
        """One batch (numpy arrays under MODEL_KEYS; float32 or uint8 images) ->
        (B, H, W) on the device, queued."""
        arrays = {k: batch[k] for k in MODEL_KEYS}
        with torch.inference_mode():
            return serving_forward(self._model, to_device(arrays, self._device),
                                   self._model_config, self._impl, self._fetch_dtype)

    def _readback(self, out: torch.Tensor, ring: ReadbackRing, step: int):
        """Queue the copy of ``out`` into the ring's slot for ``step``: (host tensor,
        event recorded after the copy, or None on the CPU)."""
        host = ring.take(step, out.shape, out.dtype)
        host.copy_(out, non_blocking=True)
        if self._device.type != "cuda":
            return host, None
        done = torch.cuda.Event()
        done.record()
        return host, done

    def run(self, dataset, batch_size=8, prefetch=4, workers=4):
        """Yields (idepthmaps (B, H, W) np.ndarray, left filenames).

        The loader stays ``prefetch`` batches ahead with ``workers`` decode threads.
        Device work and the copies are queued without blocking; a step's output is
        yielded once ``IN_FLIGHT`` later steps are queued behind it (or the data ends),
        after the event recorded behind its readback has completed, as a copy: its ring
        slot is written again ``IN_FLIGHT + 1`` steps later.
        """
        loader = BatchLoader(dataset, batch_size, shuffle=False, prefetch=prefetch,
                             drop_last=False, workers=workers)
        ring = ReadbackRing(IN_FLIGHT + 1, pin_memory=self._device.type == "cuda")
        pending = collections.deque()
        for step, batch in enumerate(loader):
            pending.append((*self._readback(self.forward(batch), ring, step),
                            batch["left_filenames"]))
            if len(pending) > IN_FLIGHT:
                yield _host_result(*pending.popleft())
        while pending:
            yield _host_result(*pending.popleft())


def _host_result(host: torch.Tensor, done, names):
    if done is not None:
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
    parser.add_argument("--device", default="cuda")
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
    device = serving_device(args.device)
    model_config = dataclasses.replace(model_config_from_params(cfg),
                                       compute_dtype="bfloat16" if args.bf16 else "float32",
                                       matmul_precision="default")
    runner = StreamingRunner(load_model(args.weights_dir, device), model_config,
                             device=device,
                             fetch_dtype=torch.float16 if args.fetch_f16 else None)

    t0 = time.perf_counter()
    count = 0
    for idepths, names in runner.run(dataset, args.batch_size, workers=args.workers):
        count += len(names)
    dt = time.perf_counter() - t0
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"{count} depthmaps in {dt:.2f}s -> {count / dt:.1f} depthmaps/sec on {name}, "
          "read back to the host")


if __name__ == "__main__":
    main()

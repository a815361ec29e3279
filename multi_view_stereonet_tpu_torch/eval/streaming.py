"""Batched streaming inference on one device.

Port of ``multi_view_stereonet_tpu/eval/streaming.py`` for one device and
float32 images (the uint8 transport, the mesh and fleet sharding come
later). A host-side loader thread keeps decoded batches ahead while the
device runs the forward; outputs stay on the device.

Usage (library):
    runner = StreamingRunner(model, MultiViewStereoNetConfig(), device="cuda")
    for idepthmaps, names in runner.run(dataset, batch_size=1):
        ...  # idepthmaps: (B, H, W) float32 tensor on the runner's device

CLI (weights: ``<weights_dir>/stereo_network.pth``, a ``torch.save`` of the
port's state dict; params: ``--params_yaml`` or ``<weights_dir>/../../params.yaml``):
    python -m multi_view_stereonet_tpu_torch.eval.streaming \
        <weights_dir> <data_dir> <split> [--batch_size 8]

The run is in float32 with TF32 off: ``main`` sets
``torch.backends.cudnn.allow_tf32 = False`` and
``torch.backends.cuda.matmul.allow_tf32 = False``; a library caller sets
them as it needs.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from multi_view_stereonet_tpu.data import (
    BatchLoader, DeMoNDataset, GTASfMMultiViewDataset, get_testing_transforms)

from ..models import MultiViewStereoNet, MultiViewStereoNetConfig, mvsnet_forward
from ..train.config import load_params_yaml
from ..train.pipeline import multi_view_unpack_batch

MODEL_KEYS = ("left_image", "right_images", "K", "T_right_in_left")
WEIGHTS_FILE = "stereo_network.pth"


def serving_forward(model, batch, config: MultiViewStereoNetConfig, impl: str = "auto"):
    """The serving computation: metric batch (f32 tensors) -> metric inverse depth (B, H, W)."""
    for key in ("left_image", "right_images"):
        if batch[key].dtype != torch.float32:
            raise TypeError(f"{key} must be float32 images (the uint8 transport is not "
                            f"ported yet), got {batch[key].dtype}")
    inputs = multi_view_unpack_batch(batch, config.num_levels)
    out = mvsnet_forward(model, inputs["left_image_pyr"], inputs["K_pyr"],
                         inputs["T_right_in_left"], inputs["right_image_pyr"], config,
                         impl)
    return out["left_idepthmap_pyr"][0] / inputs["baseline"][:, None, None]


class StreamingRunner:
    """Serves one model on one device. The model, config, device and impl are
    fixed at construction and read-only: build a new runner to change them."""

    def __init__(self, model: MultiViewStereoNet, model_config: MultiViewStereoNetConfig,
                 device=None, impl: str = "auto"):
        self._device = torch.device(device) if device is not None else (
            next(model.parameters()).device)
        self._model = model.to(self._device).eval()
        self._model_config = model_config
        self._impl = impl

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

    def forward(self, batch: dict) -> torch.Tensor:
        """One batch (numpy arrays or tensors under MODEL_KEYS) -> (B, H, W) on the device."""
        with torch.inference_mode():
            tensors = {k: torch.as_tensor(batch[k]).to(self._device) for k in MODEL_KEYS}
            return serving_forward(self._model, tensors, self._model_config, self._impl)

    def run(self, dataset, batch_size=8, prefetch=4, workers=4):
        """Yields (idepthmaps (B, H, W) tensor on the device, left filenames).

        The loader stays ``prefetch`` batches ahead with ``workers`` decode
        threads; device work is queued asynchronously, so decoding the next
        batch overlaps the device's run of this one.
        """
        loader = BatchLoader(dataset, batch_size, shuffle=False, prefetch=prefetch,
                             drop_last=False, workers=workers)
        for batch in loader:
            yield self.forward(batch), batch["left_filenames"]


def load_model(weights_dir: str, device) -> MultiViewStereoNet:
    """The port's network with ``<weights_dir>/stereo_network.pth`` loaded."""
    model = MultiViewStereoNet()
    state = torch.load(os.path.join(weights_dir, WEIGHTS_FILE), map_location="cpu",
                       weights_only=True)
    model.load_state_dict(state)
    return model.to(device).eval()


def model_config_from_params(cfg: dict) -> MultiViewStereoNetConfig:
    """The forward's knobs from a loaded params.yaml (``load_params_yaml``)."""
    return MultiViewStereoNetConfig(
        num_idepth_samples=cfg["num_idepth_samples"],
        do_cost_volume_filter=cfg["cost_volume_filter"],
        do_refiners=tuple(cfg["refiners"]),
        num_levels=cfg["num_levels"],
    )


def make_dataset(data_dir: str, split: str, cfg: dict, decode_backend: str = "auto"):
    """The test dataset of a GTA-SfM or DeMoN split, with the testing transforms."""
    transforms = get_testing_transforms(cfg)
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
    parser.add_argument("weights_dir")
    parser.add_argument("data_dir")
    parser.add_argument("test_split")
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--workers", type=int, default=4,
                        help="parallel sample-decode threads")
    parser.add_argument("--params_yaml", default=None)
    parser.add_argument("--decode_backend", default="auto",
                        choices=["auto", "native", "pil"])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    params_file = args.params_yaml or os.path.join(args.weights_dir, "..", "..",
                                                   "params.yaml")
    cfg = load_params_yaml(params_file)
    dataset = make_dataset(args.data_dir, args.test_split, cfg, args.decode_backend)
    device = torch.device(args.device)
    runner = StreamingRunner(load_model(args.weights_dir, device),
                             model_config_from_params(cfg), device=device)

    t0 = time.perf_counter()
    count = 0
    for idepths, names in runner.run(dataset, args.batch_size, workers=args.workers):
        count += len(names)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"{count} depthmaps in {dt:.2f}s -> {count / dt:.1f} depthmaps/sec on {name}")


if __name__ == "__main__":
    main()

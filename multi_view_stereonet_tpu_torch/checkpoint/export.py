"""Serving artifacts: the serving forward as a ``torch.export`` program in one ``.pt2`` file.

Port of ``multi_view_stereonet_tpu/checkpoint/export.py``. The reference deploys a
TorchScript archive (weights and code in one file, loaded without the source tree); the
JAX package a ``jax.export`` blob. Here the artifact is ``torch.export`` of THE shared
``serving_forward`` (``eval/streaming.py``), the function the live ``StreamingRunner``
calls, with the u8 gate and the fetch cast inside, the weights stored beside the graph.
It is run eagerly as its aten graph, so it computes what the live forward computes, bit
for bit, under the same TF32 flags (set them off for f32 results).

An artifact is specialized to the device it was exported on, as the JAX package's is to
its backend: exported on a card, its graph holds the four hand-written kernels as the
custom ops ``mvs_torch::grid_sample``, ``incremental_chain``, ``idepthmap_refiner`` and
``group_norm_act`` (``ops/cuda/build.py`` ``custom_op``); exported on the CPU, their
plain versions. ``load_exported`` registers the ops and builds their kernels without
importing the network's modules, and raises where they cannot be built. Shapes are static:
one artifact per serving configuration.

CLI:
  python -m multi_view_stereonet_tpu_torch.checkpoint.export \\
      <weights_dir> <out.pt2> [--size 480 640] [--batch 1] [--views 1] [--u8]
      [--fetch float16] [--dtype float32] [--device cuda]

``weights_dir`` holds ``stereo_network.pth``, ``.msgpack`` or ``.pt`` (``load_any_params``).
"""

from __future__ import annotations

import argparse
import os

import torch

FETCH_DTYPES = ("float16", "bfloat16", "float32")


class ServingModule(torch.nn.Module):
    """``serving_forward`` of ``model`` as a module: (left_image (B, H, W, 3), right_images
    (B, V, H, W, 3), both float32 or uint8, K (B, 4, 4), T_right_in_left (B, V, 4, 4))
    -> metric inverse depth (B, H, W), cast to ``fetch_dtype`` when it is given."""

    def __init__(self, model, config, fetch_dtype=None):
        super().__init__()
        from ..eval.streaming import serving_forward

        self.model = model
        self.config = config
        self.fetch_dtype = fetch_dtype
        self._serving_forward = serving_forward

    def forward(self, left_image, right_images, K, T_right_in_left):
        batch = {"left_image": left_image, "right_images": right_images, "K": K,
                 "T_right_in_left": T_right_in_left}
        return self._serving_forward(self.model, batch, self.config,
                                     fetch_dtype=self.fetch_dtype)


def make_serving_fn(model, config, fetch_dtype=None) -> ServingModule:
    """The serving computation of ``model`` (see ``ServingModule``)."""
    return ServingModule(model, config, fetch_dtype)


def _example_inputs(batch_size: int, views: int, size, input_u8: bool, device) -> tuple:
    """Serving inputs of the given shapes: gray images, a centred camera and each view
    one unit to the right."""
    H, W = size
    images = torch.uint8 if input_u8 else torch.float32
    K = torch.eye(4, device=device)
    K[0, 0] = K[1, 1] = float(W)
    K[0, 2], K[1, 2] = (W - 1) / 2, (H - 1) / 2
    T = torch.eye(4, device=device).repeat(batch_size, views, 1, 1)
    T[..., 0, 3] = 1.0
    return (torch.full((batch_size, H, W, 3), 128, dtype=images, device=device),
            torch.full((batch_size, views, H, W, 3), 128, dtype=images, device=device),
            K.repeat(batch_size, 1, 1), T)


def export_inference(model, config, batch_size: int = 1, views: int = 1,
                     size=(480, 640), input_u8: bool = False, fetch_dtype=None):
    """``torch.export`` of the serving forward at static shapes, on the model's device,
    under ``torch.no_grad()``. ``input_u8`` takes uint8 images (the serving transport,
    dequantized inside); ``fetch_dtype`` (e.g. ``torch.float16``) casts the output.

    One eager forward runs first, so that what the forward keeps on the device (the
    resize matrices, K3's packed weights) is made for real: the exported graph then
    holds those tensors as constants, which it neither copies nor recomputes at a call,
    and they are the live path's own, bit for bit."""
    serving = make_serving_fn(model.eval(), config, fetch_dtype)
    args = _example_inputs(batch_size, views, size, input_u8,
                           next(model.parameters()).device)
    with torch.no_grad():
        serving(*args)
        exported = torch.export.export(serving, args, strict=False)
    # Not kept in the artifact: the B=24 example images alone are 44 MB.
    exported.example_inputs = None
    return exported


def save_exported(exported, path: str) -> None:
    torch.export.save(exported, path)


def custom_ops(exported) -> list:
    """The names of the port's custom ops in an exported program's graph."""
    from ..ops.cuda.build import NAMESPACE

    return sorted({node.target.name() for node in exported.graph.nodes
                   if node.op == "call_function"
                   and getattr(node.target, "namespace", None) == NAMESPACE})


def load_exported(path: str):
    """The artifact at ``path`` as a module to call with (left_image, right_images, K,
    T_right_in_left); its weights need no gradient. The port's custom ops are registered
    first, and the kernels of those in the graph built: where they cannot be (no card, no
    nvcc), this raises."""
    from ..ops.cuda import build, gn_apply, incremental_chain, refiner, warp  # noqa: F401

    exported = torch.export.load(path)
    ops = custom_ops(exported)
    if ops:
        if not torch.cuda.is_available():
            raise RuntimeError(f"{path} was exported on a card ({', '.join(ops)}) and this "
                               "process has none")
        build.load_libraries(*sorted({build.OP_SOURCES[op] for op in ops}))
    module = exported.module()
    for p in module.parameters():
        p.requires_grad_(False)
    return module


def main(argv=None):
    ap = argparse.ArgumentParser(description="Export the serving forward (PyTorch).")
    ap.add_argument("weights_dir", help="a directory holding stereo_network.pth, .msgpack "
                                        "or .pt (the first found)")
    ap.add_argument("out_path")
    ap.add_argument("--size", type=int, nargs=2, default=(480, 640))
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--views", type=int, default=1)
    ap.add_argument("--dtype", default="float32",
                    help="compute dtype: float32 (bfloat16 waits for the opt-in fast modes)")
    ap.add_argument("--u8", action="store_true",
                    help="uint8 image inputs, dequantized on the device (the serving "
                         "transport)")
    ap.add_argument("--fetch", default=None, choices=FETCH_DTYPES,
                    help="cast the output to this dtype on the device (e.g. float16)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.dtype != "float32":
        ap.error(f"--dtype {args.dtype}: the port computes in float32 only; bfloat16 waits "
                 "for the opt-in fast modes")

    from ..eval.streaming import load_model, serving_device
    from ..models import MultiViewStereoNetConfig

    device = serving_device(args.device)
    model = load_model(args.weights_dir, device)
    exported = export_inference(model, MultiViewStereoNetConfig(), batch_size=args.batch,
                                views=args.views, size=tuple(args.size), input_u8=args.u8,
                                fetch_dtype=getattr(torch, args.fetch) if args.fetch else None)
    save_exported(exported, args.out_path)
    print(f"exported the serving forward on {device} to {args.out_path} "
          f"({os.path.getsize(args.out_path)} bytes); custom ops: "
          f"{', '.join(custom_ops(exported)) or 'none'}")


if __name__ == "__main__":
    main()

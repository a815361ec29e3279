"""Compute primitives: separable resizes and the homography warps.

The warps sample through ``ops.cuda.warp`` (a hand-written CUDA kernel
with a plain PyTorch version beside it); ``ops.cuda`` also holds the fused
incremental feature chain, the small-level idepthmap refiner and the
resblocks' GroupNorm tail. ``ops.quantize`` holds the u8 transport's
bit-exact dequantize.
"""

from .resize import (
    resize_bilinear,
    resize_area,
    build_image_pyramid,
    upsample_mask,
)
from .warp import (
    homography_grid,
    homography_warp,
    homography_warp_auto,
    plane_sweep_warp,
)
from .cuda.warp import grid_sample

__all__ = [
    "resize_bilinear",
    "resize_area",
    "build_image_pyramid",
    "upsample_mask",
    "homography_grid",
    "homography_warp",
    "homography_warp_auto",
    "plane_sweep_warp",
    "grid_sample",
]

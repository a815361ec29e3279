"""Homography warps and plane sweeps over the bilinear grid sample.

Port of ``multi_view_stereonet_tpu/ops/warp.py:142-223``. The sample itself
is ``ops.cuda.warp.grid_sample``: the CUDA kernel for CUDA tensors, its
plain gather version for CPU tensors or under ``impl="plain"``. Images are
NHWC, homographies (B, [D,] 3, 3) map output pixels to source pixels.
"""

from __future__ import annotations

import torch

from ..geometry.projection import pixel_grid
from .cuda.warp import grid_sample


def homography_grid(H: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Normalized sampling grid (B, ..., rows, cols, 2) for homographies H (B, ..., 3, 3)."""
    pix = pixel_grid(rows, cols, H.dtype, H.device).reshape(3, -1)
    xyz = H @ pix  # (B, ..., 3, N)
    uv = xyz[..., :2, :] / xyz[..., 2:3, :]
    x = 2.0 * (uv[..., 0, :] + 0.5) / cols - 1.0
    y = 2.0 * (uv[..., 1, :] + 0.5) / rows - 1.0
    g = torch.stack([x, y], dim=-1)
    return g.reshape(*H.shape[:-2], rows, cols, 2)


def homography_warp(image: torch.Tensor, H: torch.Tensor, impl: str = "auto"):
    """Warp image (B, H, W, C) by H (B, 3, 3): (warped, invalid (B, H, W))."""
    grid = homography_grid(H, image.shape[1], image.shape[2])
    return grid_sample(image, grid, impl=impl)


def homography_warp_auto(image: torch.Tensor, H: torch.Tensor,
                         zero_invalid: bool = False, impl: str = "auto",
                         out_dtype: torch.dtype | None = None):
    """``homography_warp`` with invalid samples optionally zeroed, written at
    ``out_dtype`` (interpolation in the image's f32, one rounding at the write).

    The JAX package routes this warp to its Pallas band kernel on the TPU;
    here the grid sample itself routes by device.
    """
    grid = homography_grid(H, image.shape[1], image.shape[2])
    return grid_sample(image, grid, zero_invalid=zero_invalid, impl=impl,
                       out_dtype=out_dtype)


def plane_sweep_warp(image: torch.Tensor, H_family: torch.Tensor,
                     zero_invalid: bool = True, impl: str = "auto"):
    """Warp image (B, H, W, C) through H_family (B, D, 3, 3).

    Returns (volume (B, D, H, W, C), invalid (B, D, H, W)); all D
    hypotheses in one grid sample.
    """
    grid = homography_grid(H_family, image.shape[1], image.shape[2])
    return grid_sample(image, grid, zero_invalid=zero_invalid, impl=impl)

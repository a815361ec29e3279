"""Separable matrix resizes (bilinear and area), the image pyramid and the same-size
average pool.

Port of ``multi_view_stereonet_tpu/ops/resize.py``. Each resize is two
small matrix products with weight matrices built once in numpy per shape
and cached on the device, which reproduces torch's conventions exactly:

- bilinear, align_corners=False, half-pixel centres with the negative
  source index clamped to 0;
- "area" = adaptive average pooling with integer bin edges.

Inputs are NHWC (B, H, W, C) or (B, H, W), as in the JAX package.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=256)
def _bilinear_matrix(out_size: int, in_size: int) -> np.ndarray:
    """(out_size, in_size) row-stochastic bilinear resampling matrix."""
    if out_size == in_size:
        return np.eye(out_size, dtype=np.float32)
    scale = in_size / out_size
    dst = np.arange(out_size, dtype=np.float64)
    src = (dst + 0.5) * scale - 0.5
    src = np.maximum(src, 0.0)  # torch clamps negative source indices to 0
    i0 = np.floor(src).astype(np.int64)
    i0 = np.minimum(i0, in_size - 1)
    lam = (src - i0).astype(np.float32)
    i1 = np.minimum(i0 + 1, in_size - 1)
    M = np.zeros((out_size, in_size), dtype=np.float32)
    M[np.arange(out_size), i0] += 1.0 - lam
    M[np.arange(out_size), i1] += lam
    return M


@functools.lru_cache(maxsize=256)
def _area_matrix(out_size: int, in_size: int) -> np.ndarray:
    """(out_size, in_size) adaptive-average-pooling matrix."""
    if out_size == in_size:
        return np.eye(out_size, dtype=np.float32)
    M = np.zeros((out_size, in_size), dtype=np.float32)
    for i in range(out_size):
        start = (i * in_size) // out_size
        end = -((-(i + 1) * in_size) // out_size)  # ceil
        M[i, start:end] = 1.0 / (end - start)
    return M


_MATRICES = {"bilinear": _bilinear_matrix, "area": _area_matrix}


@functools.lru_cache(maxsize=256)
def _device_matrix(kind: str, out_size: int, in_size: int, device, dtype):
    # Made outside inference mode even when first asked for inside it: an inference
    # tensor in the cache could not be saved for a later training step's backward.
    with torch.inference_mode(False):
        return torch.from_numpy(_MATRICES[kind](out_size, in_size)).to(device, dtype)


def _apply_separable(x: torch.Tensor, kind: str, out_size) -> torch.Tensor:
    rows, cols = out_size
    Mh = _device_matrix(kind, rows, x.shape[1], x.device, x.dtype)
    Mw = _device_matrix(kind, cols, x.shape[2], x.device, x.dtype)
    if x.ndim == 3:
        return torch.einsum("pw,bow->bop", Mw, torch.einsum("oh,bhw->bow", Mh, x))
    return torch.einsum("pw,bowc->bopc", Mw, torch.einsum("oh,bhwc->bowc", Mh, x))


def resize_bilinear(x: torch.Tensor, out_size) -> torch.Tensor:
    """Bilinear resize (align_corners=False) of NHWC or NHW input."""
    return _apply_separable(x, "bilinear", out_size)


def resize_area(x: torch.Tensor, out_size) -> torch.Tensor:
    """Area (adaptive average pooling) resize of NHWC or NHW input."""
    return _apply_separable(x, "area", out_size)


def build_image_pyramid(image: torch.Tensor, num_levels: int) -> list:
    """Area-downsampled pyramid with ceil-halved sizes; image (B, H, W, C)."""
    pyr = [image]
    for _ in range(1, num_levels):
        h = (pyr[-1].shape[1] + 1) // 2
        w = (pyr[-1].shape[2] + 1) // 2
        pyr.append(resize_area(pyr[-1], (h, w)))
    return pyr


def upsample_mask(mask: torch.Tensor, out_size) -> torch.Tensor:
    """Bilinear-upsample a boolean (B, H, W[, C]) mask, re-threshold at 0.5."""
    return resize_bilinear(mask.to(torch.float32), out_size) > 0.5


def avg_pool_same(x: torch.Tensor, patch: int) -> torch.Tensor:
    """Same-size mean over ``patch`` x ``patch`` windows of NHWC or NHW input, the zero
    padding counted in the mean (``avg_pool2d(x, patch, 1, patch // 2)`` with
    count_include_pad=True, the reference's SSIM pooling). Differentiable."""
    squeeze = x.ndim == 3
    nchw = (x[:, None] if squeeze else x.permute(0, 3, 1, 2))
    out = F.avg_pool2d(nchw, patch, stride=1, padding=patch // 2, count_include_pad=True)
    return out[:, 0] if squeeze else out.permute(0, 2, 3, 1)

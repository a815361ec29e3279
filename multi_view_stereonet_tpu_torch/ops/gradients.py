"""Image gradients and Gaussian blur, NHWC (B, H, W, C).

Port of ``multi_view_stereonet_tpu/ops/gradients.py``. The gradients pad by
replicating the edge. The reference's GaussianBlur is a depthwise conv built with
``padding_mode="border"``, a mode torch never implemented for convs: torch 1.5 took
any unknown mode as zero padding, so the blur here is a zero-padded depthwise conv,
as in the JAX package. The blur's conv runs at the open precision scope's mode
(``ops/precision.py``; the train step's losses: exact), its gradient too.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .precision import convolution


def forward_gradx(image: torch.Tensor) -> torch.Tensor:
    """x[i] - x[i+1] along the width, the last column replicated."""
    pad = torch.cat([image, image[:, :, -1:]], dim=2)
    return pad[:, :, :-1] - pad[:, :, 1:]


def forward_grady(image: torch.Tensor) -> torch.Tensor:
    """x[i] - x[i+1] along the height, the last row replicated."""
    pad = torch.cat([image, image[:, -1:]], dim=1)
    return pad[:, :-1] - pad[:, 1:]


def central_gradx(image: torch.Tensor) -> torch.Tensor:
    """0.5 * (x[i+1] - x[i-1]) along the width, the edges replicated."""
    pad = torch.cat([image[:, :, :1], image, image[:, :, -1:]], dim=2)
    return 0.5 * (pad[:, :, 2:] - pad[:, :, :-2])


def central_grady(image: torch.Tensor) -> torch.Tensor:
    """0.5 * (x[i+1] - x[i-1]) along the height, the edges replicated."""
    pad = torch.cat([image[:, :1], image, image[:, -1:]], dim=1)
    return 0.5 * (pad[:, 2:] - pad[:, :-2])


@functools.lru_cache(maxsize=16)
def _gaussian_kernel(kernel_size: int, sigma: float) -> np.ndarray:
    coords = np.arange(kernel_size, dtype=np.float64)
    mean = (kernel_size - 1) / 2.0
    g = np.exp(-((coords - mean) ** 2) / (2 * sigma ** 2))
    k2 = np.outer(g, g)
    return (k2 / k2.sum()).astype(np.float32)


def gaussian_blur(image: torch.Tensor, kernel_size: int = 5,
                  sigma: float = 1.0) -> torch.Tensor:
    """Depthwise Gaussian blur with zero padding, same size."""
    C = image.shape[-1]
    k = torch.from_numpy(_gaussian_kernel(kernel_size, sigma)).to(image.device, image.dtype)
    w = k.expand(C, 1, kernel_size, kernel_size)
    pad = kernel_size // 2
    out = convolution(image.permute(0, 3, 1, 2), w, None, (1, 1), (pad, pad), (1, 1), C)
    return out.permute(0, 2, 3, 1)


def blur_with_zeros(image: torch.Tensor, kernel_size: int = 5,
                    sigma: float = 1.0) -> torch.Tensor:
    """Gaussian blur that ignores entries <= 0: the blurred image over the blurred
    validity mask, 0 where no valid entry is in reach."""
    mask = (image > 0).to(image.dtype)
    blurred = gaussian_blur(image, kernel_size, sigma)
    weights = gaussian_blur(mask, kernel_size, sigma)
    empty = weights == 0
    return torch.where(empty, torch.zeros_like(blurred),
                       blurred / torch.where(empty, torch.ones_like(weights), weights))

"""Feature-quality regularizers, defined for capability parity: the training recipe does
not use them, as the reference does not (utils/losses.py:20-89).

Port of ``multi_view_stereonet_tpu/losses/regularizers.py``; features NHWC.
"""

from __future__ import annotations

import torch

from ..ops import avg_pool_same
from ..ops.gradients import central_gradx, central_grady
from ..parallel.mesh import batch_mean


def _znorm(features: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Per image and channel: (f - mean) / (std + eps), the std unbiased (ddof = 1) as
    ``torch.std`` in the reference."""
    mu = features.mean(dim=(1, 2), keepdim=True)
    n = features.shape[1] * features.shape[2]
    var = (features - mu).square().sum(dim=(1, 2), keepdim=True) / (n - 1)
    return (features - mu) / (var.sqrt() + eps)


def corner_loss(features: torch.Tensor, patch_size: int) -> torch.Tensor:
    """exp(-0.1 * mean det(structure tensor)) of the normalized features: low where the
    features have corners."""
    z = _znorm(features)
    gx = central_gradx(z)
    gy = central_grady(z)
    gx2 = avg_pool_same(gx * gx, patch_size)
    gy2 = avg_pool_same(gy * gy, patch_size)
    gxy = avg_pool_same(gx * gy, patch_size)
    return torch.exp(-0.1 * batch_mean(gx2 * gy2 - gxy * gxy))


def gradient_matching_loss(image: torch.Tensor, features: torch.Tensor) -> torch.Tensor:
    """exp(-mean projection of the normalized features' gradients on the image's unit
    gradients). image (B, H, W, C); features (B, H, W, Cf)."""
    gx_i = central_gradx(image).mean(dim=-1)
    gy_i = central_grady(image).mean(dim=-1)
    mag = torch.sqrt(gx_i * gx_i + gy_i * gy_i)
    gxn = gx_i / (mag + 1e-3)
    gyn = gy_i / (mag + 1e-3)
    z = _znorm(features)
    gx_f = central_gradx(z).mean(dim=-1)
    gy_f = central_grady(z).mean(dim=-1)
    return torch.exp(-batch_mean(gxn * gx_f + gyn * gy_f))

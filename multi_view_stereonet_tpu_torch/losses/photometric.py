"""Photometric losses: SSIM, the SSIM + L1 reconstruction loss, edge-aware smoothness.

Port of ``multi_view_stereonet_tpu/losses/photometric.py``; images NHWC (B, H, W, C).
"""

from __future__ import annotations

import torch

from ..ops import avg_pool_same
from ..ops.gradients import forward_gradx, forward_grady, gaussian_blur
from ..parallel.mesh import batch_mean
from .supervised import l1, masked_mean


def ssim(x: torch.Tensor, y: torch.Tensor, patch_size: int = 3) -> torch.Tensor:
    """Monodepth's SSIM distance map, (1 - SSIM) / 2 clamped to [0, 1], with means and
    variances over ``patch_size`` windows (zero padding counted). The clamp is
    ``maximum`` then ``minimum``, which split the gradient evenly at a tie, as
    ``jnp.clip`` does (``torch.clamp`` would give it all to the input)."""
    C1 = 0.01 ** 2
    C2 = 0.03 ** 2
    mu_x = avg_pool_same(x, patch_size)
    mu_y = avg_pool_same(y, patch_size)
    sigma_x = avg_pool_same(x * x, patch_size) - mu_x * mu_x
    sigma_y = avg_pool_same(y * y, patch_size) - mu_y * mu_y
    sigma_xy = avg_pool_same(x * y, patch_size) - mu_x * mu_y
    n = (2 * mu_x * mu_y + C1) * (2 * sigma_xy + C2)
    d = (mu_x * mu_x + mu_y * mu_y + C1) * (sigma_x + sigma_y + C2)
    s = (1 - n / d) / 2
    return torch.minimum(torch.maximum(s, s.new_zeros(())), s.new_ones(()))


def reconstruction_photometric_loss(image: torch.Tensor, image_pred: torch.Tensor,
                                    invalid_mask: torch.Tensor,
                                    ssim_factor: float = 0.85) -> torch.Tensor:
    """0.85 * SSIM + 0.15 * L1 over the valid pixels.

    image, image_pred: (B, H, W, C); invalid_mask: (B, H, W) bool, True = left out.
    The SSIM term also leaves out the pixels next to an invalid one (the mask dilated
    by a 3x3 mean), since SSIM reads a pixel's neighbours."""
    valid = (~invalid_mask[..., None]).expand(image.shape)
    l1_loss = masked_mean(l1(image_pred - image), valid)
    patch = 3
    dilated = avg_pool_same(invalid_mask.to(image.dtype), patch) > 0
    dvalid = (~dilated[..., None]).expand(image.shape)
    ssim_loss = masked_mean(ssim(image_pred, image, patch), dvalid)
    return ssim_factor * ssim_loss + (1.0 - ssim_factor) * l1_loss


def smoothness_loss(image: torch.Tensor, output: torch.Tensor, alpha: float) -> torch.Tensor:
    """Edge-aware TV-L1 smoothness of ``output`` (B, H, W, Co), weighted by
    exp(-alpha * |gradient|) of the Gaussian-blurred ``image`` (B, H, W, C)."""
    image_smooth = gaussian_blur(image, 5, 1.0)
    wx = torch.exp(-alpha * l1(forward_gradx(image_smooth)).mean(dim=-1, keepdim=True))
    wy = torch.exp(-alpha * l1(forward_grady(image_smooth)).mean(dim=-1, keepdim=True))
    return (batch_mean(l1(forward_gradx(output)) * wx)
            + batch_mean(l1(forward_grady(output)) * wy))

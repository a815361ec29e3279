"""Supervised inverse-depth losses.

Port of ``multi_view_stereonet_tpu/losses/supervised.py``. Tensors on any
device; nothing here reads a value back to the host. Every mean over the batch is
over the global batch inside a data-parallel step (``parallel.mesh.batch_sums``).
"""

from __future__ import annotations

import torch

from ..ops import resize_bilinear
from ..parallel.mesh import batch_mean, batch_sums


def l1(x: torch.Tensor) -> torch.Tensor:
    """|x| with the gradient of ``jnp.abs``: +1 at x = 0, where ``torch.abs`` gives 0.
    The tie is common in the losses: a predicted pixel equal to the image (both
    saturated), an idepth map flat at 0."""
    return torch.where(x >= 0, x, -x)


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of x over the elements where mask is True; an empty mask gives 0, not 0/0,
    so a batch with no valid truth cannot poison a step. Equal to the plain mean
    whenever the mask is not empty. In a data-parallel step the sum and the count are
    the global batch's, and so is the empty-mask rule."""
    m = mask.to(x.dtype)
    total, count = batch_sums((x * m).sum(), m.sum())
    return torch.where(count > 0, total / count.clamp_min(1.0), 0.0)


def pseudo_huber_loss(truth: torch.Tensor, pred: torch.Tensor, scale: float = 2.0,
                      mask=None) -> torch.Tensor:
    """mean(sqrt(((pred - truth) / scale)^2 + 1) - 1) over the masked elements
    (reference utils/losses.py:11-18, scale 2)."""
    elem = torch.sqrt(torch.square((pred - truth) / scale) + 1.0) - 1.0
    if mask is None:
        return batch_mean(elem)
    return masked_mean(elem, mask)


def supervised_idepthmap_loss(idepthmap: torch.Tensor, truth: torch.Tensor,
                              truth_mask: torch.Tensor, scale_factor: float = 1000.0,
                              normalize: bool = True) -> torch.Tensor:
    """Pseudo-Huber loss between a prediction resized to the truth and the true idepth.

    idepthmap: (B, h, w) at any level; truth, truth_mask: (B, H, W). The prediction is
    resized bilinearly to (H, W); both sides are divided by each image's mean valid
    true idepth and scaled by ``scale_factor``. An image with no valid truth divides by
    1 instead of 0/0 and adds nothing through the mask (reference
    multi_view_stereonet/losses.py:14-40, which asserts on that input instead).
    """
    pred = resize_bilinear(idepthmap, truth.shape[-2:])
    if normalize:
        m = truth_mask.to(truth.dtype)
        count = m.sum(dim=(1, 2), keepdim=True)
        mean_idepths = (truth * m).sum(dim=(1, 2), keepdim=True) / count.clamp_min(1.0)
        mean_idepths = torch.where(count > 0, mean_idepths, 1.0)
    else:
        mean_idepths = torch.ones_like(truth[:, :1, :1])
    t = scale_factor * truth / mean_idepths
    p = scale_factor * pred / mean_idepths
    return pseudo_huber_loss(t, p, mask=truth_mask)

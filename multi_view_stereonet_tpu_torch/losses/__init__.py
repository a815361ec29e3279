"""Training losses: supervised, photometric, consistency, regularizers.

Port of ``multi_view_stereonet_tpu.losses``: boolean-mask indexing of the reference
(multi_view_stereonet/losses.py, utils/losses.py) becomes masked reductions with the
same means, an empty mask contributing 0.
"""

from .supervised import masked_mean, pseudo_huber_loss, supervised_idepthmap_loss
from .photometric import ssim, reconstruction_photometric_loss, smoothness_loss
from .consistency import (
    get_occlusion_mask,
    reconstruction_loss,
    left_right_idepthmap_consistency_losses,
)
from .regularizers import corner_loss, gradient_matching_loss
from .compute import compute_losses, LossConfig

__all__ = [
    "masked_mean",
    "pseudo_huber_loss",
    "supervised_idepthmap_loss",
    "ssim",
    "reconstruction_photometric_loss",
    "smoothness_loss",
    "get_occlusion_mask",
    "reconstruction_loss",
    "left_right_idepthmap_consistency_losses",
    "corner_loss",
    "gradient_matching_loss",
    "compute_losses",
    "LossConfig",
]

"""Losses: the supervised inverse-depth loss and its dispatcher."""

from .compute import LossConfig, compute_losses
from .supervised import masked_mean, pseudo_huber_loss, supervised_idepthmap_loss

__all__ = ["LossConfig", "compute_losses", "masked_mean", "pseudo_huber_loss",
           "supervised_idepthmap_loss"]

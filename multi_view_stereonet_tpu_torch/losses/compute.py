"""Loss dispatcher: the supervised branch.

Port of ``multi_view_stereonet_tpu/losses/compute.py:23-71``, the part the
multi-view eval runs: the shipped pretrained recipe is pure supervision
(supervision_factor 1, the others 0) with idepth_scale_factor 100. The
photometric reconstruction, left-right consistency and two-view branches
are not ported yet (ROADMAP.md M8): a config or output that needs one raises.
"""

from __future__ import annotations

import dataclasses

from .supervised import supervised_idepthmap_loss


@dataclasses.dataclass(frozen=True)
class LossConfig:
    supervision_factor: float = 1.0
    reconstruction_factor: float = 0.0
    left_right_factor: float = 0.0
    idepth_scale_factor: float = 100.0


def compute_losses(inputs: dict, outputs: dict, config: LossConfig):
    """Returns (total loss, loss dict, predictions dict).

    inputs: ``multi_view_unpack_batch``'s, with left_idepthmap_true (B, H, W);
    outputs: the forward's (left_idepthmap_pyr and left_idepthmap_raw_pyr, (B, h, w)).
    The supervised loss is the mean over the refined levels and the raw coarsest one.
    """
    if (config.reconstruction_factor > 0.0 or config.left_right_factor > 0.0
            or "right_idepthmap_pyr" in outputs):
        raise NotImplementedError(
            "only the supervised loss is ported: the reconstruction and left-right "
            "consistency losses and the two-view outputs come with ROADMAP.md M8")
    loss = 0.0
    loss_dict = {}
    if config.supervision_factor > 0.0:
        left_true = inputs["left_idepthmap_true"]
        left_mask = left_true > 0
        supervised_losses = [
            supervised_idepthmap_loss(idepth, left_true, left_mask,
                                      config.idepth_scale_factor)
            for idepth in outputs["left_idepthmap_pyr"] if idepth is not None]
        # The raw coarsest level (reference multi_view_stereonet_utils.py:689-692).
        supervised_losses.append(supervised_idepthmap_loss(
            outputs["left_idepthmap_raw_pyr"][-1], left_true, left_mask,
            config.idepth_scale_factor))
        loss_dict["supervised_losses"] = supervised_losses
        supervised_loss = sum(supervised_losses) / len(supervised_losses)
        loss = loss + config.supervision_factor * supervised_loss
        loss_dict["supervised_loss"] = supervised_loss
    return loss, loss_dict, {}

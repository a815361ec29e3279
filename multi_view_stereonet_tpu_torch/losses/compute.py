"""Loss dispatcher: the weighted sum of the supervised, left-right consistency and
reconstruction losses.

Port of ``multi_view_stereonet_tpu/losses/compute.py`` (reference compute_losses,
multi_view_stereonet_utils.py:664-793). The shipped recipe is pure supervision
(supervision_factor 1, the others 0) with idepth_scale_factor 100; the two-view recipe
(``estimate_right_idepthmap``) adds the right view's outputs, from which come occlusion
masks, the left-right branch and the reconstruction branch. Every sample of those goes
through ``ops.cuda.warp.grid_sample`` under ``impl``.
"""

from __future__ import annotations

import dataclasses

from .consistency import (
    get_occlusion_mask, left_right_idepthmap_consistency_losses, reconstruction_loss)
from .supervised import supervised_idepthmap_loss


@dataclasses.dataclass(frozen=True)
class LossConfig:
    supervision_factor: float = 1.0
    reconstruction_factor: float = 0.0
    left_right_factor: float = 0.0
    idepth_scale_factor: float = 100.0


def compute_losses(inputs: dict, outputs: dict, config: LossConfig, impl: str = "auto"):
    """Returns (total loss, loss dict, predictions dict).

    inputs: an unpack's, with left_idepthmap_true (B, H, W) [and right_idepthmap_true],
    K_pyr, T_right_in_left and T_left_in_right (B, 4, 4), left/right_image_pyr.
    outputs: the forward's pyramids of (B, h, w), and with ``right_idepthmap_pyr`` the
    second forward's (the two-view recipe). The reconstruction and left-right losses
    need those right-view outputs: asking for either without them raises a ValueError
    (the JAX package fails there with a KeyError on ``left_occlusion_mask_pyr``).
    """
    two_view = "right_idepthmap_pyr" in outputs
    if (config.reconstruction_factor > 0.0 or config.left_right_factor > 0.0) and not two_view:
        raise ValueError(
            "the reconstruction and left-right losses need the right view's outputs "
            "(right_idepthmap_pyr, from the estimate_right_idepthmap forward); these "
            "outputs have only the left view's")
    loss = 0.0
    loss_dict = {}
    predictions = {}
    left_pyr = outputs["left_idepthmap_pyr"]
    n = len(left_pyr)

    if config.supervision_factor > 0.0:
        left_true = inputs["left_idepthmap_true"]
        left_mask = left_true > 0
        supervised_losses = [
            supervised_idepthmap_loss(idepth, left_true, left_mask,
                                      config.idepth_scale_factor)
            for idepth in left_pyr if idepth is not None]
        # The raw coarsest level (reference multi_view_stereonet_utils.py:689-692).
        supervised_losses.append(supervised_idepthmap_loss(
            outputs["left_idepthmap_raw_pyr"][-1], left_true, left_mask,
            config.idepth_scale_factor))
        if two_view:
            right_true = inputs["right_idepthmap_true"]
            right_mask = right_true > 0
            supervised_losses += [
                supervised_idepthmap_loss(idepth, right_true, right_mask,
                                          config.idepth_scale_factor)
                for idepth in outputs["right_idepthmap_pyr"] if idepth is not None]
        loss_dict["supervised_losses"] = supervised_losses
        supervised_loss = sum(supervised_losses) / len(supervised_losses)
        loss = loss + config.supervision_factor * supervised_loss
        loss_dict["supervised_loss"] = supervised_loss

    if two_view:
        # Occlusion masks by level (:712-746), and of the truth at full resolution.
        right_pyr = outputs["right_idepthmap_pyr"]
        K_pyr, T_rl, T_lr = inputs["K_pyr"], inputs["T_right_in_left"], inputs["T_left_in_right"]
        left_occ = [None] * n
        right_occ = [None] * n
        for lvl in range(n):
            if left_pyr[lvl] is None:
                continue
            left_occ[lvl] = get_occlusion_mask(K_pyr[lvl], T_rl, left_pyr[lvl], None,
                                               right_pyr[lvl], None, impl)
            right_occ[lvl] = get_occlusion_mask(K_pyr[lvl], T_lr, right_pyr[lvl], None,
                                                left_pyr[lvl], None, impl)
        predictions["left_occlusion_mask_pyr"] = left_occ
        predictions["right_occlusion_mask_pyr"] = right_occ
        left_true, right_true = inputs["left_idepthmap_true"], inputs["right_idepthmap_true"]
        predictions["left_occlusion_mask_true"] = get_occlusion_mask(
            K_pyr[0], T_rl, left_true, None, right_true, None, impl)
        predictions["right_occlusion_mask_true"] = get_occlusion_mask(
            K_pyr[0], T_lr, right_true, None, left_true, None, impl)

    if config.left_right_factor > 0.0:
        lr_loss = left_right_idepthmap_consistency_losses(
            inputs["T_right_in_left"], inputs["T_left_in_right"], inputs["K_pyr"],
            left_pyr, predictions["left_occlusion_mask_pyr"],
            outputs["right_idepthmap_pyr"], predictions["right_occlusion_mask_pyr"], impl)
        loss = loss + config.left_right_factor * lr_loss
        loss_dict["left_right_loss"] = lr_loss

    if config.reconstruction_factor > 0.0:
        K0 = inputs["K_pyr"][0]
        left_image, right_image = inputs["left_image_pyr"][0], inputs["right_image_pyr"][0]
        recon_losses = []
        for side, T, image, other in (("left", inputs["T_right_in_left"], left_image,
                                       right_image),
                                      ("right", inputs["T_left_in_right"], right_image,
                                       left_image)):
            preds = [None] * n
            for lvl, idepth in enumerate(outputs[f"{side}_idepthmap_pyr"]):
                if idepth is None:
                    continue
                r, preds[lvl] = reconstruction_loss(
                    T, K0, image, other, idepth,
                    predictions[f"{side}_occlusion_mask_pyr"][lvl], impl)
                recon_losses.append(r)
            predictions[f"{side}_image_pred_pyr"] = preds
        loss_dict["reconstruction_losses"] = recon_losses
        recon_loss = sum(recon_losses)
        loss = loss + config.reconstruction_factor * recon_loss
        loss_dict["reconstruction_loss"] = recon_loss

    return loss, loss_dict, predictions

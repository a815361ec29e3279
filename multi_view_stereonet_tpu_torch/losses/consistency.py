"""Cross-view consistency: occlusion masks, view-synthesis reconstruction and left-right
idepth consistency.

Port of ``multi_view_stereonet_tpu/losses/consistency.py``. Every sample goes through
``ops.cuda.warp.grid_sample``: the K1 kernel for CUDA tensors, its plain version for
CPU tensors or under ``impl="plain"``. Here the kernel runs under autograd with a
gradient to the sampled map and to the grid, which is projected from predicted idepth;
its backward is K1's backward kernel (``ops.cuda.warp.grid_sample_backward``).
"""

from __future__ import annotations

import torch

from ..geometry import project_idepthmap, se3_inverse
from ..geometry.projection import backproject_idepthmap, project_points
from ..ops import resize_bilinear
from ..ops.cuda.warp import grid_sample
from .photometric import reconstruction_photometric_loss
from .supervised import l1, masked_mean


def predict_image_from_idepth(K, T_right_in_left, left_idepthmap, right_image,
                              impl: str = "auto"):
    """The left image predicted by sampling the right image where each left pixel
    projects. K, T_right_in_left (B, 4, 4); left_idepthmap (B, H, W); right_image
    (B, H, W, C). Returns (pred (B, H, W, C), invalid (B, H, W))."""
    T_left_in_right = se3_inverse(T_right_in_left)
    points = backproject_idepthmap(K, left_idepthmap)
    pixels = project_points(K, T_left_in_right, right_image.shape[1:3], points)
    invalid = (pixels[..., 0].abs() > 1.0) | (pixels[..., 1].abs() > 1.0)
    pred, _ = grid_sample(right_image, pixels, impl=impl)
    return pred, invalid


def get_occlusion_mask(K, T_right_in_left, left_idepthmap, left_invalid_mask,
                       right_idepthmap, right_invalid_mask, impl: str = "auto"):
    """Left pixels occluded in the right view, (B, H, W) bool, True = occluded.

    A pixel is occluded where the right idepth sampled at its projection exceeds its
    projected idepth by more than the image's mean absolute difference, or where it
    projects outside the right image. The invalid masks are taken for the reference's
    signature and not used, as there (losses.py:75-76)."""
    del left_invalid_mask, right_invalid_mask
    B = left_idepthmap.shape[0]
    uv_prime, id_prime, prime_invalid = project_idepthmap(K, T_right_in_left, left_idepthmap)
    id_pred, _ = grid_sample(right_idepthmap[..., None], uv_prime, impl=impl)
    id_diff = id_pred[..., 0] - id_prime
    thresh = id_diff.reshape(B, -1).abs().mean(dim=1)[:, None, None]
    return (id_diff > thresh) | prime_invalid


def reconstruction_loss(T_right_in_left, K, left_image, right_image, left_idepthmap,
                        left_occlusion_mask, impl: str = "auto"):
    """View-synthesis loss at the image's resolution.

    left_idepthmap, left_occlusion_mask: (B, h, w) at any level, resized to the image.
    Returns (loss, predicted left image (B, H, W, C))."""
    size = left_image.shape[1:3]
    idepth = resize_bilinear(left_idepthmap, size)
    occ = resize_bilinear(left_occlusion_mask.to(left_image.dtype), size) > 0.5
    pred, _ = predict_image_from_idepth(K, T_right_in_left, idepth, right_image, impl)
    return reconstruction_photometric_loss(left_image, pred, occ), pred


def left_right_idepthmap_consistency_losses(
        T_right_in_left, T_left_in_right, K_pyr, left_idepthmap_pyr,
        left_occlusion_mask_pyr, right_idepthmap_pyr, right_occlusion_mask_pyr,
        impl: str = "auto"):
    """Sum over the refined levels of the L1 between each view's projected idepth and the
    other view's idepth sampled there, over the pixels unoccluded in both views. Entries
    (B, h, w); a level whose left idepth is None is skipped."""
    loss = 0.0
    for lvl, left in enumerate(left_idepthmap_pyr):
        if left is None:
            continue
        K = K_pyr[lvl]
        right = right_idepthmap_pyr[lvl]
        left_occ = left_occlusion_mask_pyr[lvl]
        right_occ = right_occlusion_mask_pyr[lvl]

        l2r_pix, l2r_id, _ = project_idepthmap(K, T_right_in_left, left)
        r_samp, _ = grid_sample(right[..., None], l2r_pix, impl=impl)
        r_occ_samp, _ = grid_sample(right_occ[..., None].to(torch.float32), l2r_pix,
                                    impl=impl)
        r_unocc = ~left_occ & ~(r_occ_samp[..., 0] > 0)
        # 0 where no pixel is unoccluded in both views, which can rightly happen: the
        # reference's boolean-index mean gives NaN there (losses.py:136-138).
        right_loss = masked_mean(l1(l2r_id - r_samp[..., 0]), r_unocc)

        r2l_pix, r2l_id, _ = project_idepthmap(K, T_left_in_right, right)
        l_samp, _ = grid_sample(left[..., None], r2l_pix, impl=impl)
        l_occ_samp, _ = grid_sample(left_occ[..., None].to(torch.float32), r2l_pix,
                                    impl=impl)
        l_unocc = ~right_occ & ~(l_occ_samp[..., 0] > 0)
        left_loss = masked_mean(l1(r2l_id - l_samp[..., 0]), l_unocc)

        loss = loss + right_loss + left_loss
    return loss

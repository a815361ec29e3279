"""Rectified and general-disparity view synthesis for a two-view pair.

Port of ``multi_view_stereonet_tpu/ops/stereo_warp.py`` (the reference's
RectifiedImagePredictor, image_predictor.py:289-351, and ImagePredictor, :578-601):
a horizontal shift for rectified pairs, and disparity -> idepth -> project -> sample
for general motion. Both sample through ``ops.cuda.warp.grid_sample`` under ``impl``.
"""

from __future__ import annotations

import torch

from ..geometry import disparity_to_idepth, project_idepthmap
from ..geometry.projection import normalize_pixel_coords, pixel_grid
from .cuda.warp import grid_sample


def rectified_image_predictor(K, T_right_in_left, left_disparity, right_image,
                              impl: str = "auto"):
    """The left image predicted from a rectified pair and the left disparity.

    K, T_right_in_left (B, 4, 4); left_disparity (B, H, W); right_image (B, H, W, C).
    The shift follows sign(tx) (image_predictor.py:322-327). Returns (pred
    (B, H, W, C), invalid (B, H, W))."""
    B, rows, cols = left_disparity.shape
    pix = pixel_grid(rows, cols, left_disparity.dtype, left_disparity.device)
    sign = torch.sign(T_right_in_left[:, 0, 3])[:, None, None]
    x = pix[0][None] - sign * left_disparity
    y = pix[1][None].expand(x.shape)
    grid = normalize_pixel_coords(torch.stack([x, y], dim=-1), rows, cols)
    return grid_sample(right_image, grid, impl=impl)


def disparity_image_predictor(K, T_right_in_left, left_disparity, right_image,
                              impl: str = "auto"):
    """The left image predicted from a general (non-rectified) disparity: disparity ->
    idepth -> projection into the right camera -> sample. Returns (pred (B, H, W, C),
    invalid (B, H, W): the projection outside the right image)."""
    idepth = disparity_to_idepth(K, T_right_in_left, left_disparity)
    pixels, _, invalid = project_idepthmap(K, T_right_in_left, idepth)
    pred, _ = grid_sample(right_image, pixels, impl=impl)
    return pred, invalid

"""Batch unpacking for the forward: the two-view and the multi-view batch.

Port of ``multi_view_stereonet_tpu/train/pipeline.py``. Tensors, on the batch's
device: images NHWC (B, H, W, 3); the two-view batch has one right image (B, H, W, 3)
and T_right_in_left (B, 4, 4), the multi-view batch right views (B, V, H, W, 3) and
T_right_in_left (B, V, 4, 4); K (B, 4, 4); optional depthmaps (B, H, W) and, for the
multi-view right views, (B, V, H, W).
"""

from __future__ import annotations

import torch

from ..geometry import baseline_norm, build_K_pyramid, normalize_baseline, se3_inverse
from ..parallel.mesh import local_views
from ..ops import build_image_pyramid


def pyramid_sizes(H: int, W: int, num_levels: int):
    sizes = [(H, W)]
    for _ in range(1, num_levels):
        H = (H + 1) // 2
        W = (W + 1) // 2
        sizes.append((H, W))
    return sizes


def _idepth_from_depth(depth: torch.Tensor) -> torch.Tensor:
    """1/depth where depth > 0, else depth."""
    pos = depth > 0
    return torch.where(pos, 1.0 / torch.where(pos, depth, torch.ones_like(depth)), depth)


def unpack_batch(batch: dict, num_levels: int = 5) -> dict:
    """Two-view unpack: the pose scaled to a unit baseline, both truth depthmaps divided
    by that baseline, area pyramids of both images, the K pyramid. A batch with
    left_depthmap_true must have right_depthmap_true too."""
    left = batch["left_image"]
    H, W = left.shape[1], left.shape[2]
    T_right_in_left, baseline = normalize_baseline(batch["T_right_in_left"])
    inputs = {
        "T_right_in_left": T_right_in_left,
        "T_left_in_right": se3_inverse(T_right_in_left),
        "K_pyr": build_K_pyramid(batch["K"], pyramid_sizes(H, W, num_levels)),
        "left_image_pyr": build_image_pyramid(left, num_levels),
        "right_image_pyr": build_image_pyramid(batch["right_image"], num_levels),
        "baseline": baseline,
    }
    if "left_depthmap_true" in batch:
        b = baseline[:, None, None]
        for side in ("left", "right"):
            depth = batch[f"{side}_depthmap_true"] / b
            inputs[f"{side}_depthmap_true"] = depth
            inputs[f"{side}_idepthmap_true"] = _idepth_from_depth(depth)
    return inputs


def multi_view_unpack_batch(batch: dict, num_levels: int = 5) -> dict:
    """Poses scaled by the FIRST right camera's baseline; area pyramids; K pyramid."""
    left = batch["left_image"]
    rights = batch["right_images"]
    B, V = rights.shape[0], rights.shape[1]
    H, W = left.shape[1], left.shape[2]

    # (B, V, 4, 4), every view's also where a step shards the views: the first one's
    # baseline scales them all, then this rank keeps its own (parallel/mesh.py).
    T = batch["T_right_in_left"]
    baseline = baseline_norm(T[:, 0])  # (B,)
    T = local_views(T).clone()
    T[..., :3, 3] = T[..., :3, 3] / baseline[:, None, None]

    left_pyr = build_image_pyramid(left, num_levels)
    rights_flat = build_image_pyramid(rights.reshape((B * V,) + rights.shape[2:]),
                                      num_levels)
    right_pyrs = [r.reshape((B, V) + r.shape[1:]) for r in rights_flat]

    inputs = {
        "T_right_in_left": T,
        "T_left_in_right": se3_inverse(T),
        "K_pyr": build_K_pyramid(batch["K"], pyramid_sizes(H, W, num_levels)),
        "left_image_pyr": left_pyr,
        "right_image_pyr": right_pyrs,
        "baseline": baseline,
    }

    if "left_depthmap_true" in batch:
        inputs["left_depthmap_true"] = batch["left_depthmap_true"] / baseline[:, None, None]
        inputs["left_idepthmap_true"] = _idepth_from_depth(inputs["left_depthmap_true"])
        if "right_depthmap_true" in batch:
            inputs["right_depthmap_true"] = (batch["right_depthmap_true"]
                                             / baseline[:, None, None, None])
            inputs["right_idepthmap_true"] = _idepth_from_depth(
                inputs["right_depthmap_true"])
    return inputs

"""MultiViewStereoNet: coarse-to-fine multi-view stereo with incremental features.

Port of ``multi_view_stereonet_tpu/models/mvsnet.py:194-603`` (the serving
forward). Public layouts are the JAX package's: image pyramids NHWC
(B, h, w, 3) and (B, V, h, w, 3), intrinsics and poses (B, 4, 4) and
(B, V, 4, 4), volumes (B, D, h, w, C). Inside, the convs run NCHW.

The comparison views are folded into the batch (N = B*V); the left image
and the min-idepth-warped right images go through the feature extractor
as one batch, which is per-sample and so changes no value. Four
hand-written CUDA kernels run on the card: the grid sample (min-idepth
warp and plane sweep), the incremental chain, the whole idepthmap refiner
at the small levels (``fused_refiner_supported``: 4 and 3 at 480x640), and
the GroupNorm tail of every other resblock. ``impl`` ("auto" | "kernel" |
"plain") reaches all four; see ops/cuda/build.py.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn as nn

from ..geometry import (
    create_idepth_samples,
    create_plane_sweep_homographies,
    incremental_homographies,
    normalize_baseline,
)
from ..ops import homography_warp_auto, plane_sweep_warp, resize_bilinear, upsample_mask
from ..ops.cuda.build import use_kernel
from ..ops.cuda.incremental_chain import incremental_chain
from ..ops.cuda.refiner import fused_refiner_supported, idepthmap_refiner
from .cost_volume import CostVolumeFilter, extract_idepthmap
from .feature_network import FeatureNetwork
from .refiners import FeatureRefiner, IDepthmapRefiner

NUM_LEVELS = 5
FEATURE_CHANNELS = 32


@dataclasses.dataclass(frozen=True)
class MultiViewStereoNetConfig:
    """The forward's knobs that change results."""
    num_idepth_samples: int = 12
    do_cost_volume_filter: bool = True
    do_refiners: Sequence[bool] = (True, True, True, True, True)
    num_levels: int = NUM_LEVELS


class RightFeatureExtractor(nn.Module):
    """Holds the incremental chain's FeatureRefiner under the reference's name;
    the right views share the left extractor's weights."""

    def __init__(self):
        super().__init__()
        self.refiner = FeatureRefiner(FEATURE_CHANNELS)


class MultiViewStereoNet(nn.Module):
    """The network's weights, named as the reference's modules."""

    def __init__(self):
        super().__init__()
        self.left_feature_extractor = FeatureNetwork(3)
        self.right_feature_extractor = RightFeatureExtractor()
        self.volume_filter4 = CostVolumeFilter(FEATURE_CHANNELS)
        for lvl in range(4, 0, -1):
            self.add_module(f"refiner{lvl}", IDepthmapRefiner(FEATURE_CHANNELS + 3))
        self.refiner0 = IDepthmapRefiner(3)

    def forward(self, left_image_pyr, K_pyr, T_right_in_lefts, right_image_pyrs,
                config: MultiViewStereoNetConfig = MultiViewStereoNetConfig(),
                impl: str = "auto"):
        return mvsnet_forward(self, left_image_pyr, K_pyr, T_right_in_lefts,
                              right_image_pyrs, config, impl)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def min_idepth_warp(T_right_in_left, K0, right_image0, idepth_samples, impl="auto"):
    """Full-res right image (N, H, W, 3) warped at the min-idepth hypothesis,
    invalid samples zeroed."""
    H_min = create_plane_sweep_homographies(T_right_in_left, K0, idepth_samples[:, :1])
    warped0, _ = homography_warp_auto(right_image0, H_min[:, 0], zero_invalid=True,
                                      impl=impl)
    return warped0


def incremental_right_features(net, T_right_in_left, K4, right_image4, idepth_samples,
                               feats0, impl="auto"):
    """Incrementally warped right feature volume (the paper's core trick).

    T_right_in_left, K4: (N, 4, 4); right_image4: (N, h4, w4, 3);
    idepth_samples: (N, D); feats0: (N, h4, w4, C), the extractor's
    features of the min-idepth warp. Returns (volume (N, D, h4, w4, C),
    invalid mask (N, D, h4, w4)), invalid voxels zeroed by the global
    sweep mask.
    """
    H_fam = create_plane_sweep_homographies(T_right_in_left, K4, idepth_samples)
    image_volume, mask_volume = plane_sweep_warp(right_image4, H_fam, impl=impl)
    H_inc = incremental_homographies(H_fam)
    feature_volume = incremental_chain(net.right_feature_extractor.refiner, feats0,
                                       image_volume[:, 1:], H_inc, impl=impl)
    feature_volume = feature_volume.masked_fill(mask_volume[..., None], 0.0)
    return feature_volume, mask_volume


def _refine_level(refiner, guidance, idepth_prior, fx, impl="auto"):
    """Run a refiner on fx-scaled idepth and scale back: a small level on the
    card as one kernel, any other as the module (its resblock tails kernels)."""
    scale = fx[:, None, None]
    n, _, h, w = guidance.shape
    if use_kernel(impl, guidance) and fused_refiner_supported(h, w, n):
        refined = idepthmap_refiner(refiner, guidance, idepth_prior * scale, impl)
    else:
        refined = refiner(guidance, idepth_prior * scale, impl=impl)
    return refined / scale


def mvsnet_forward(net, left_image_pyr, K_pyr, T_right_in_lefts, right_image_pyrs,
                   config: MultiViewStereoNetConfig, impl: str = "auto"):
    """Estimate the left inverse-depth pyramid.

    left_image_pyr: 5 levels of (B, h, w, 3); K_pyr: 5 levels of (B, 4, 4);
    T_right_in_lefts: (B, V, 4, 4), any baseline (renormalized per view);
    right_image_pyrs: 5 levels of (B, V, h, w, 3).

    Returns a dict of pyramids, level 0 first:
      left_idepthmap_pyr      [(B, h, w)] refined estimates
      left_idepthmap_raw_pyr  [(B, h, w)] pre-refiner priors
      left_idepthmap_mask_pyr [(B, D, h, w)] invalid masks
    """
    if len(left_image_pyr) != NUM_LEVELS or config.num_levels != NUM_LEVELS:
        raise ValueError(f"the network has {NUM_LEVELS} pyramid levels")
    D = config.num_idepth_samples
    do_refiners = tuple(config.do_refiners)
    B, V = T_right_in_lefts.shape[0], T_right_in_lefts.shape[1]
    h4, w4 = left_image_pyr[4].shape[1], left_image_pyr[4].shape[2]

    # ---- Level 4: per-view plane sweeps, views folded into the batch ----
    T_bv, baseline = normalize_baseline(T_right_in_lefts.reshape(B * V, 4, 4))
    K4_bv = K_pyr[4].repeat_interleave(V, dim=0)
    K0_bv = K_pyr[0].repeat_interleave(V, dim=0)
    right0_bv = right_image_pyrs[0].reshape((B * V,) + right_image_pyrs[0].shape[2:])
    right4_bv = right_image_pyrs[4].reshape((B * V,) + right_image_pyrs[4].shape[2:])

    idepth_samples = create_idepth_samples(T_bv, K4_bv, h4, w4, D)  # (B*V, D)
    warped0 = min_idepth_warp(T_bv, K0_bv, right0_bv, idepth_samples, impl)

    # Left and min-idepth right features from one extractor call (B + B*V).
    stacked_pyr = net.left_feature_extractor(
        _nchw(torch.cat([left_image_pyr[0], warped0], dim=0)), impl=impl)
    left_feature_pyr = [lvl[:B] for lvl in stacked_pyr]
    right_feats0 = stacked_pyr[-1][B:].permute(0, 2, 3, 1).contiguous()
    left_feats4 = left_feature_pyr[-1]  # (B, C, h4, w4)

    right_feat_vol, right_mask_vol = incremental_right_features(
        net, T_bv, K4_bv, right4_bv, idepth_samples, right_feats0, impl)

    # Cost |left - right|, invalid voxels zeroed.
    left_vol = left_feats4.permute(0, 2, 3, 1).repeat_interleave(V, dim=0)[:, None]
    cost = (left_vol - right_feat_vol).abs().masked_fill(right_mask_vol[..., None], 0.0)
    if config.do_cost_volume_filter:
        cost_volume = net.volume_filter4(cost.permute(0, 4, 1, 2, 3))
    else:
        cost_volume = torch.sqrt(torch.sum(cost.float() ** 2, dim=-1))
    idepth4_raw = extract_idepthmap(cost_volume, idepth_samples)  # (B*V, h4, w4)

    # Un-normalize by the per-view baseline, then average over views.
    b_hw = baseline[:, None, None]
    if do_refiners[4]:
        guidance4 = torch.cat([_nchw(left_image_pyr[4]), left_feats4], dim=1)
        idepth4 = _refine_level(net.refiner4, guidance4.repeat_interleave(V, dim=0),
                                idepth4_raw, K4_bv[:, 0, 0], impl)
        idepth4_raw = idepth4_raw / b_hw
        idepth4 = idepth4 / b_hw
    else:
        # Reference quirk kept: with refiner4 off the refined map aliases
        # the raw one, and both in-place divisions hit it: baseline^2.
        idepth4_raw = idepth4_raw / (b_hw * b_hw)
        idepth4 = idepth4_raw

    idepth4_raw = idepth4_raw.reshape(B, V, h4, w4).mean(dim=1)
    idepth4 = idepth4.reshape(B, V, h4, w4).mean(dim=1)
    mask4 = right_mask_vol.reshape(B, V, D, h4, w4).float().mean(dim=1) > 0.5

    # ---- Levels 3..0: upsample and guided refinement ----
    idepthmap_pyr = [None] * NUM_LEVELS
    raw_pyr = [None] * NUM_LEVELS
    mask_pyr = [None] * NUM_LEVELS
    idepthmap_pyr[4], raw_pyr[4], mask_pyr[4] = idepth4, idepth4_raw, mask4

    prev_idepth, prev_mask = idepth4, mask4
    for lvl in range(3, -1, -1):
        out_size = (left_image_pyr[lvl].shape[1], left_image_pyr[lvl].shape[2])
        prior = resize_bilinear(prev_idepth, out_size)
        # The mask volume upsampled with D as the channel axis.
        mask_lvl = upsample_mask(prev_mask.permute(0, 2, 3, 1), out_size).permute(0, 3, 1, 2)
        if do_refiners[lvl]:
            guidance = _nchw(left_image_pyr[lvl])
            if lvl > 0:
                guidance = torch.cat([guidance, left_feature_pyr[lvl]], dim=1)
            idepth_lvl = _refine_level(getattr(net, f"refiner{lvl}"), guidance, prior,
                                       K_pyr[lvl][:, 0, 0], impl)
        else:
            idepth_lvl = prior
        idepthmap_pyr[lvl], raw_pyr[lvl], mask_pyr[lvl] = idepth_lvl, prior, mask_lvl
        prev_idepth, prev_mask = idepth_lvl, mask_lvl

    return {
        "left_idepthmap_pyr": idepthmap_pyr,
        "left_idepthmap_raw_pyr": raw_pyr,
        "left_idepthmap_mask_pyr": mask_pyr,
    }

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
GroupNorm -> LeakyReLU (+ residual) everywhere else: the extractor's and
the larger refiners' resblocks, those refiners' bn0 and the cost filter.
``impl`` ("auto" | "kernel" | "plain") reaches all four; see
ops/cuda/build.py. Under autograd each kernel runs in a ``torch.autograd.Function``
whose backward is a hand-written kernel too, beside its plain version in closed form.

``compute_dtype`` / ``refiner_dtype`` / ``frontend_dtype`` ("float32" or
"bfloat16") select the storage dtype of the activations, as the JAX forward
(``multi_view_stereonet_tpu/models/mvsnet.py:404-581``) resolves and casts them off
the TPU (``resolve_dtypes``): the min-idepth warp writes and the extractor runs at
the frontend dtype, the incremental chain, the cost and its filter at the
extractor's output dtype, the refiners' convs at the refiner dtype. Geometry,
the soft-argmin, the refiners' residual adds and every output stay float32.
float32 everywhere is the default, and at it no value is cast.

``matmul_precision`` and ``stage_precision`` set the convs' precision stage by stage,
as the JAX forward scopes ``jax.default_matmul_precision`` (``mvsnet.py:390-500``);
``resolve_precision`` maps the JAX names onto this card (exact f32 or TF32), and each
stage runs in an ``ops.precision.scope``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn as nn
import torch.utils.checkpoint

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
from ..ops.precision import scope
from ..parallel.mesh import view_mean
from .cost_volume import CostVolumeFilter, extract_idepthmap
from .feature_network import FeatureNetwork
from .refiners import FeatureRefiner, IDepthmapRefiner

NUM_LEVELS = 5
FEATURE_CHANNELS = 32
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# The JAX precision names (``jax.default_matmul_precision``'s, with its aliases) -> the
# mode of ops/precision.py they run at on this card (``resolve_precision``).
PRECISIONS = {"default": "ieee", "bfloat16": "ieee", "highest": "ieee", "float32": "ieee",
              "high": "tf32", "tensorfloat32": "tf32"}
STAGES = ("extractor", "chain", "cost", "refiners", "warp")


@dataclasses.dataclass(frozen=True)
class MultiViewStereoNetConfig:
    """The forward's knobs that change results."""
    num_idepth_samples: int = 12
    do_cost_volume_filter: bool = True
    do_refiners: Sequence[bool] = (True, True, True, True, True)
    num_levels: int = NUM_LEVELS
    # Recompute each idepthmap refiner's activations in the backward instead of keeping
    # them (torch.utils.checkpoint): the level-0 refiner's resblocks hold most of a
    # training step's memory. Values are unchanged. Under it the recomputed forward
    # goes through the kernels again, so their counters count it.
    remat_refiners: bool = False
    # Storage dtype of the activations ("float32" or "bfloat16"); the convs accumulate
    # in f32 and the weights stay f32 in the state dict.
    compute_dtype: str = "float32"
    # The idepthmap refiners' and the frontend's (min-idepth warp output, extractor)
    # dtypes; "auto" follows compute_dtype, the JAX rule off the TPU (its TPU-only bf16
    # "auto" is not ported).
    refiner_dtype: str = "auto"
    frontend_dtype: str = "auto"
    # The convs' matmul precision, a JAX name ("default" | "high" | "highest", or the
    # aliases "bfloat16" | "tensorfloat32" | "float32"); see resolve_precision.
    matmul_precision: str = "default"
    # Per-stage overrides of matmul_precision: (stage, precision) pairs, stages in
    # STAGES, e.g. (("refiners", "highest"),).
    stage_precision: tuple = ()


def resolve_dtypes(config: MultiViewStereoNetConfig) -> tuple:
    """(compute, refiner, frontend) torch dtypes of ``config``: an explicit name is
    taken as it is, "auto" (refiner and frontend only) is compute_dtype."""
    def dtype(name, field):
        if name not in DTYPES:
            raise ValueError(f"{field} must be one of {tuple(DTYPES)}"
                             f"{'' if field == 'compute_dtype' else ' or auto'}, got {name!r}")
        return DTYPES[name]
    cdt = dtype(config.compute_dtype, "compute_dtype")
    rdt = cdt if config.refiner_dtype == "auto" else dtype(config.refiner_dtype,
                                                           "refiner_dtype")
    fdt = cdt if config.frontend_dtype == "auto" else dtype(config.frontend_dtype,
                                                            "frontend_dtype")
    return cdt, rdt, fdt


def resolve_precision(config: MultiViewStereoNetConfig) -> tuple:
    """(ambient mode, {stage: mode}) of ``config``: the ``ops.precision`` mode the forward
    runs outside its stages and in each of ``STAGES``. A stage's override replaces the
    ambient precision there, as ``prec(stage)`` does in the JAX forward
    (``mvsnet.py:412-415``); an empty override is none, as there.

    The JAX names resolve as JAX computes them off the TPU, where "default" is exact (a
    TF32 fast mode is opt-in):

    ========================  ====  ==============================================
    JAX precision             mode  on the card
    ========================  ====  ==============================================
    "highest" / "float32"     ieee  exact f32: cuDNN's TF32 off, K2 and K3 3xTF32
    "default" / "bfloat16"    ieee  the same as "highest" (JAX on the CPU: exact)
    "high" / "tensorfloat32"  tf32  cuDNN's convs at TF32, K2 and K3 1xTF32
    ========================  ====  ==============================================

    The stages: "extractor" the feature network; "chain" the plane sweep and K2 (or its
    plain loop's convs); "cost" the cost filter's conv3ds; "refiners" K3 at the small
    levels and the refiner modules' convs elsewhere; "warp" the min-idepth warp, K1,
    which interpolates without a matmul and so is exact at every precision (the override
    is accepted and changes nothing, as in JAX off the TPU). At bf16 storage K2 and K3
    take their bf16 path and the convs take bf16 operands at every precision, as the
    JAX convs do. cuBLAS's TF32 stays off at every mode: the resizes, the soft-argmin
    and the homographies are exact, as the JAX package pins them. An unknown precision
    raises ValueError, as ``jax.default_matmul_precision`` does; so does an unknown
    stage, which the JAX forward ignores."""
    def mode(name, field):
        if name not in PRECISIONS:
            raise ValueError(f"{field} must be one of {tuple(PRECISIONS)}, got {name!r}")
        return PRECISIONS[name]
    ambient = mode(config.matmul_precision, "matmul_precision")
    overrides = dict(config.stage_precision)
    unknown = sorted(set(overrides) - set(STAGES), key=str)
    if unknown:
        raise ValueError(f"stage_precision stages must be in {STAGES}, got {unknown}")
    return ambient, {stage: mode(overrides[stage], f"stage_precision[{stage!r}]")
                     if overrides.get(stage) else ambient for stage in STAGES}


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


def min_idepth_warp(T_right_in_left, K0, right_image0, idepth_samples, impl="auto",
                    out_dtype=None):
    """Full-res right image (N, H, W, 3) warped at the min-idepth hypothesis,
    invalid samples zeroed; interpolated in f32 and written at ``out_dtype``."""
    H_min = create_plane_sweep_homographies(T_right_in_left, K0, idepth_samples[:, :1])
    warped0, _ = homography_warp_auto(right_image0, H_min[:, 0], zero_invalid=True,
                                      impl=impl, out_dtype=out_dtype)
    return warped0


def incremental_right_features(net, T_right_in_left, K4, right_image4, idepth_samples,
                               feats0, impl="auto"):
    """Incrementally warped right feature volume (the paper's core trick).

    T_right_in_left, K4: (N, 4, 4); right_image4: (N, h4, w4, 3);
    idepth_samples: (N, D); feats0: (N, h4, w4, C), the extractor's
    features of the min-idepth warp. Returns (volume (N, D, h4, w4, C) at
    feats0's dtype, invalid mask (N, D, h4, w4)), invalid voxels zeroed by
    the global sweep mask.
    """
    H_fam = create_plane_sweep_homographies(T_right_in_left, K4, idepth_samples)
    image_volume, mask_volume = plane_sweep_warp(right_image4, H_fam, impl=impl)
    H_inc = incremental_homographies(H_fam)
    feature_volume = incremental_chain(net.right_feature_extractor.refiner, feats0,
                                       image_volume[:, 1:], H_inc, impl=impl)
    feature_volume = feature_volume.masked_fill(mask_volume[..., None], 0.0)
    return feature_volume, mask_volume


def _refine_level(refiner, guidance, idepth_prior, fx, impl="auto", remat=False,
                  dtype=torch.float32, mode="ieee"):
    """Run a refiner on fx-scaled idepth and scale back: a small level on the
    card as one kernel, any other as the module (its resblock tails kernels).
    The convs run at ``dtype`` and at the precision ``mode`` (the "refiners" stage's),
    the residual add in the prior's f32. ``remat`` recomputes the refiner in the
    backward (``remat_refiners``), at ``mode`` again."""
    scale = fx[:, None, None]
    n, _, h, w = guidance.shape
    guidance = guidance.to(dtype)

    def refine(guidance, idepth):
        with scope(mode):
            if use_kernel(impl, guidance) and fused_refiner_supported(h, w, n):
                return idepthmap_refiner(refiner, guidance, idepth, impl)
            return refiner(guidance, idepth, impl=impl, dtype=dtype)
    if remat and torch.is_grad_enabled():
        refined = torch.utils.checkpoint.checkpoint(refine, guidance, idepth_prior * scale,
                                                    use_reentrant=False)
    else:
        refined = refine(guidance, idepth_prior * scale)
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

    Runs at the config's precision (``resolve_precision``), whatever the caller's TF32
    flags, and leaves them as it found them.
    """
    if len(left_image_pyr) != NUM_LEVELS or config.num_levels != NUM_LEVELS:
        raise ValueError(f"the network has {NUM_LEVELS} pyramid levels")
    ambient, modes = resolve_precision(config)
    with scope(ambient):
        return _forward(net, left_image_pyr, K_pyr, T_right_in_lefts, right_image_pyrs,
                        config, impl, modes)


def _forward(net, left_image_pyr, K_pyr, T_right_in_lefts, right_image_pyrs, config,
             impl, modes):
    D = config.num_idepth_samples
    do_refiners = tuple(config.do_refiners)
    cdt, rdt, fdt = resolve_dtypes(config)
    B, V = T_right_in_lefts.shape[0], T_right_in_lefts.shape[1]
    h4, w4 = left_image_pyr[4].shape[1], left_image_pyr[4].shape[2]

    # ---- Level 4: per-view plane sweeps, views folded into the batch ----
    T_bv, baseline = normalize_baseline(T_right_in_lefts.reshape(B * V, 4, 4))
    K4_bv = K_pyr[4].repeat_interleave(V, dim=0)
    K0_bv = K_pyr[0].repeat_interleave(V, dim=0)
    right0_bv = right_image_pyrs[0].reshape((B * V,) + right_image_pyrs[0].shape[2:])
    right4_bv = right_image_pyrs[4].reshape((B * V,) + right_image_pyrs[4].shape[2:])

    idepth_samples = create_idepth_samples(T_bv, K4_bv, h4, w4, D)  # (B*V, D)
    warped0 = min_idepth_warp(T_bv, K0_bv, right0_bv, idepth_samples, impl, out_dtype=fdt)

    # Left and min-idepth right features from one extractor call (B + B*V), at the
    # frontend dtype; the chain, the cost and its filter then run at the features'.
    with scope(modes["extractor"]):
        stacked_pyr = net.left_feature_extractor(
            _nchw(torch.cat([left_image_pyr[0].to(fdt), warped0], dim=0)), impl=impl)
    left_feature_pyr = [lvl[:B] for lvl in stacked_pyr]
    right_feats0 = stacked_pyr[-1][B:].permute(0, 2, 3, 1).contiguous()
    left_feats4 = left_feature_pyr[-1]  # (B, C, h4, w4)

    with scope(modes["chain"]):
        right_feat_vol, right_mask_vol = incremental_right_features(
            net, T_bv, K4_bv, right4_bv, idepth_samples, right_feats0, impl)

    # Cost |left - right|, invalid voxels zeroed.
    left_vol = left_feats4.permute(0, 2, 3, 1).repeat_interleave(V, dim=0)[:, None]
    cost = (left_vol - right_feat_vol).abs().masked_fill(right_mask_vol[..., None], 0.0)
    if config.do_cost_volume_filter:
        with scope(modes["cost"]):
            cost_volume = net.volume_filter4(cost.permute(0, 4, 1, 2, 3), impl=impl)
    else:
        cost_volume = torch.sqrt(torch.sum(cost.float() ** 2, dim=-1))
    idepth4_raw = extract_idepthmap(cost_volume, idepth_samples)  # (B*V, h4, w4), f32

    # Un-normalize by the per-view baseline, then average over views.
    b_hw = baseline[:, None, None]
    if do_refiners[4]:
        guidance4 = torch.cat([_nchw(left_image_pyr[4]).to(rdt), left_feats4.to(rdt)], dim=1)
        idepth4 = _refine_level(net.refiner4, guidance4.repeat_interleave(V, dim=0),
                                idepth4_raw, K4_bv[:, 0, 0], impl, config.remat_refiners,
                                rdt, modes["refiners"])
        idepth4_raw = idepth4_raw / b_hw
        idepth4 = idepth4 / b_hw
    else:
        # Reference quirk kept: with refiner4 off the refined map aliases
        # the raw one, and both in-place divisions hit it: baseline^2.
        idepth4_raw = idepth4_raw / (b_hw * b_hw)
        idepth4 = idepth4_raw

    # Over the view group's every view where a step shards them (parallel/mesh.py).
    idepth4_raw = view_mean(idepth4_raw.reshape(B, V, h4, w4))
    idepth4 = view_mean(idepth4.reshape(B, V, h4, w4))
    mask4 = view_mean(right_mask_vol.reshape(B, V, D, h4, w4).float()) > 0.5

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
            # The image at compute_dtype, and the features beside it at the promotion of
            # the two, as jnp.concatenate promotes; the refiner casts to its own dtype.
            guidance = _nchw(left_image_pyr[lvl]).to(cdt)
            if lvl > 0:
                feats = left_feature_pyr[lvl]
                dt = torch.promote_types(cdt, feats.dtype)
                guidance = torch.cat([guidance.to(dt), feats.to(dt)], dim=1)
            idepth_lvl = _refine_level(getattr(net, f"refiner{lvl}"), guidance, prior,
                                       K_pyr[lvl][:, 0, 0], impl, config.remat_refiners,
                                       rdt, modes["refiners"])
        else:
            idepth_lvl = prior
        idepthmap_pyr[lvl], raw_pyr[lvl], mask_pyr[lvl] = idepth_lvl, prior, mask_lvl
        prev_idepth, prev_mask = idepth_lvl, mask_lvl

    return {
        "left_idepthmap_pyr": idepthmap_pyr,
        "left_idepthmap_raw_pyr": raw_pyr,
        "left_idepthmap_mask_pyr": mask_pyr,
    }

"""Guided refinement heads: the feature refiner and the idepthmap refiner.

Port of ``multi_view_stereonet_tpu/models/refiners.py``. NCHW. The feature
refiner runs at its inputs' dtype, its residual sum taken in f32 and rounded once;
the idepthmap refiner's convs at its ``dtype`` and its residual add at the
idepthmap's (``refiners.py:59-75``).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .layers import ResnetBlock, conv, conv2d, conv_group_norm_leaky, group_norm

DILATIONS = (1, 2, 4, 8, 1, 1)


class FeatureRefiner(nn.Module):
    """conv(3 + C -> 32) -> GN -> LeakyReLU -> resblock -> conv(32 -> C);
    returns features + delta. Concat order [image, features]."""

    def __init__(self, feature_channels: int = 32):
        super().__init__()
        self.conv0 = conv2d(feature_channels + 3, 32, 3)
        self.bn0 = group_norm(32)
        self.res0 = ResnetBlock(32, dilation=DILATIONS[0])
        self.conv_final = conv2d(32, feature_channels, 3)

    def forward(self, image, features, impl: str = "auto"):
        """image (B, 3, H, W), features (B, C, H, W), one dtype; ``impl`` reaches every
        GroupNorm (ops/cuda/build.py)."""
        x = conv_group_norm_leaky(self.conv0, self.bn0, torch.cat([image, features], dim=1),
                                  impl=impl)
        x = self.res0(x, impl=impl)
        if features.dtype == torch.float32:
            return features + conv(self.conv_final, x)
        return (features.float() + conv(self.conv_final, x, torch.float32)).to(features.dtype)


class IDepthmapRefiner(nn.Module):
    """conv(Cg + 1 -> 32) -> GN -> LeakyReLU -> six dilated resblocks ->
    conv(32 -> 1); returns ReLU(idepth + delta). Concat order [guidance, idepth]."""

    def __init__(self, guidance_channels: int):
        super().__init__()
        self.conv0 = conv2d(guidance_channels + 1, 32, 3)
        self.bn0 = group_norm(32)
        for i, dil in enumerate(DILATIONS):
            self.add_module(f"res{i}", ResnetBlock(32, dilation=dil))
        self.conv_final = conv2d(32, 1, 3)

    def forward(self, guidance, idepthmap, impl: str = "auto",
                dtype: torch.dtype | None = None):
        """guidance (B, Cg, H, W), idepthmap (B, H, W) -> (B, H, W), at the idepthmap's
        dtype; the convs run at ``dtype`` (the idepthmap's by default). ``impl``
        reaches every GroupNorm, bn0's and the resblocks' (ops/cuda/build.py)."""
        dt = dtype or idepthmap.dtype
        x = torch.cat([guidance.to(dt), idepthmap[:, None].to(dt)], dim=1)
        x = conv_group_norm_leaky(self.conv0, self.bn0, x, impl=impl)
        for i in range(len(DILATIONS)):
            x = getattr(self, f"res{i}")(x, impl=impl)
        delta = conv(self.conv_final, x, idepthmap.dtype)[:, 0]
        return torch.relu(idepthmap + delta)

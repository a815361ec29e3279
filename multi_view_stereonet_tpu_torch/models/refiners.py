"""Guided refinement heads: the feature refiner and the idepthmap refiner.

Port of ``multi_view_stereonet_tpu/models/refiners.py``. NCHW.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .layers import ResnetBlock, conv2d, group_norm, leaky_relu

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
        x = leaky_relu(self.bn0(self.conv0(torch.cat([image, features], dim=1))))
        x = self.res0(x, impl=impl)
        return features + self.conv_final(x)


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

    def forward(self, guidance, idepthmap, impl: str = "auto"):
        """guidance (B, Cg, H, W), idepthmap (B, H, W) -> (B, H, W); ``impl``
        reaches the resblocks' GroupNorm tails (ops/cuda/build.py)."""
        x = torch.cat([guidance, idepthmap[:, None]], dim=1)
        x = leaky_relu(self.bn0(self.conv0(x)))
        for i in range(len(DILATIONS)):
            x = getattr(self, f"res{i}")(x, impl=impl)
        return torch.relu(idepthmap + self.conv_final(x)[:, 0])

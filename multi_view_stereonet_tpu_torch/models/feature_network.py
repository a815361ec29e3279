"""Shared multi-scale feature extractor.

Port of the plain path of ``multi_view_stereonet_tpu/models/
feature_network.py:65-94``: four 5x5 stride-2 convs (3->32->32->32->32,
no bias), six residual blocks (no bias), a 3x3 conv_final (bias). NCHW,
at the input's dtype (the forward's frontend dtype).
"""

from __future__ import annotations

import torch.nn as nn

from .layers import ResnetBlock, conv, conv2d

CHANNELS = (3, 32, 32, 32, 32)
NUM_RES_BLOCKS = 6


class FeatureNetwork(nn.Module):
    def __init__(self, in_channels: int = 3):
        super().__init__()
        chans = (in_channels,) + CHANNELS[1:]
        for i in range(4):
            self.add_module(f"conv{i}", conv2d(chans[i], chans[i + 1], 5, stride=2,
                                               bias=False))
        for i in range(NUM_RES_BLOCKS):
            self.add_module(f"res{i}", ResnetBlock(chans[-1], bias=False))
        self.conv_final = conv2d(chans[-1], chans[-1], 3)

    def forward(self, x, impl: str = "auto"):
        """x (B, 3, H, W) -> [x, conv0, conv1, conv2, features], NCHW, at x's dtype."""
        pyramid = [x]
        h = x
        for i in range(3):
            h = conv(getattr(self, f"conv{i}"), h)
            pyramid.append(h)
        h = conv(self.conv3, h)
        for i in range(NUM_RES_BLOCKS):
            h = getattr(self, f"res{i}")(h, impl=impl)
        pyramid.append(conv(self.conv_final, h))
        return pyramid

"""Primitive layers: "same"-padded convs, GroupNorm(C // 8), residual block.

Port of ``multi_view_stereonet_tpu/models/layers.py:25-154``. Modules take
NCHW (or NCDHW) tensors, PyTorch's own layout; the model converts from the
JAX package's NHWC at its boundary. Module and parameter names follow the
reference network, so a state dict maps one to one onto its checkpoints.
"""

from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F

from ..ops.cuda.gn_apply import gn_apply_residual

LEAKY_SLOPE = 0.2
GN_EPS = 1e-5


def conv2d(cin: int, cout: int, k: int, stride: int = 1, dilation: int = 1,
           bias: bool = True) -> nn.Conv2d:
    """Conv2d with "same" padding (k // 2) * dilation."""
    return nn.Conv2d(cin, cout, k, stride=stride, padding=(k // 2) * dilation,
                     dilation=dilation, bias=bias)


def conv3d(cin: int, cout: int, k: int = 3) -> nn.Conv3d:
    """Conv3d with "same" padding k // 2 over (D, H, W)."""
    return nn.Conv3d(cin, cout, k, padding=k // 2)


def group_norm(channels: int) -> nn.GroupNorm:
    """GroupNorm(C // 8, C), eps 1e-5."""
    return nn.GroupNorm(channels // 8, channels, eps=GN_EPS)


def leaky_relu(x):
    return F.leaky_relu(x, LEAKY_SLOPE)


class ResnetBlock(nn.Module):
    """conv3x3 -> GroupNorm -> LeakyReLU(0.2) -> + identity (no final activation)."""

    def __init__(self, channels: int, dilation: int = 1, bias: bool = True):
        super().__init__()
        self.conv1 = conv2d(channels, channels, 3, dilation=dilation, bias=bias)
        self.bn1 = group_norm(channels)

    def forward(self, x, impl: str = "auto"):
        """The tail (GroupNorm, LeakyReLU, + x) is ``ops.cuda.gn_apply``'s kernel for
        CUDA tensors; ``impl`` as in ops/cuda/build.py."""
        return gn_apply_residual(self.conv1(x), x, self.bn1.weight, self.bn1.bias,
                                 self.bn1.num_groups, impl)

"""3-D cost-volume filter and the soft-argmin idepth extraction.

Port of ``multi_view_stereonet_tpu/models/cost_volume.py:18-34, 54-67``.
The filter takes NCDHW (B, C, D, H, W), PyTorch's Conv3d layout, and runs at
its input's dtype; its output, the soft-argmin's input, is f32 (the last conv's
bias added in f32), and so is the soft-argmin.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .layers import conv, conv3d, conv_group_norm_leaky, group_norm


class CostVolumeFilter(nn.Module):
    """Four Conv3d(32 -> 32) + GroupNorm(4) + LeakyReLU, then Conv3d(32 -> 1)."""

    def __init__(self, channels: int = 32):
        super().__init__()
        for i in range(4):
            self.add_module(f"conv{i}", conv3d(channels, channels))
            self.add_module(f"bn{i}", group_norm(channels))
        self.conv4 = conv3d(channels, 1)

    def forward(self, volume, impl: str = "auto"):
        """volume (B, C, D, H, W) -> filtered cost (B, D, H, W), f32; ``impl`` reaches the
        GroupNorms (ops/cuda/build.py)."""
        x = volume
        for i in range(4):
            x = conv_group_norm_leaky(getattr(self, f"conv{i}"), getattr(self, f"bn{i}"), x,
                                      impl=impl)
        return conv(self.conv4, x, torch.float32)[:, 0]


def extract_idepthmap(cost_volume: torch.Tensor, idepth_samples: torch.Tensor,
                      beta: float = 1.0) -> torch.Tensor:
    """Soft-argmin in float32: sum_d softmin(beta * cost)_d * idepth_d.

    cost_volume (B, D, H, W), idepth_samples (B, D) -> (B, H, W).
    """
    probs = torch.softmax(-beta * cost_volume.float(), dim=1)
    return torch.einsum("bdhw,bd->bhw", probs, idepth_samples.float())

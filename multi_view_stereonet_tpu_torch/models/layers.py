"""Primitive layers: "same"-padded convs, GroupNorm(C // 8) -> LeakyReLU, residual block.

Port of ``multi_view_stereonet_tpu/models/layers.py:25-154``. Modules take
NCHW (or NCDHW) tensors, PyTorch's own layout; the model converts from the
JAX package's NHWC at its boundary. Module and parameter names follow the
reference network, so a state dict maps one to one onto its checkpoints.

A layer runs at its input's dtype, as the JAX layers do: a conv below f32 casts
its f32 weight at the call and rounds its output to that dtype (``conv``),
GroupNorm takes its statistics in f32 and writes its input's dtype. Where a
conv's output goes straight into f32 arithmetic (a GroupNorm, the refiner's
residual, the soft-argmin) its bias is added there in f32, unrounded, as the
Pallas kernels add it and as XLA computes the JAX layers' ``conv + b``; where
the conv's output is stored, the bias is added at its dtype. The casts are
explicit, not ``torch.autocast``, whose per-op lists would move the rounding
points away from the JAX package's.

Every conv goes through ``ops.precision.convolution``: at the precision of the stage
scope it runs in (``ops/precision.py``), its backward too, and at the caller's flags
outside every scope.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.cuda.gn_apply import group_norm_act
from ..ops.precision import convolution

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


def _conv(module, x: torch.Tensor, weight, bias) -> torch.Tensor:
    """``module``'s conv of x with ``weight`` and ``bias``, at the scope's precision."""
    return convolution(x, weight, bias, module.stride, module.padding, module.dilation,
                       module.groups)


def _conv_unbiased(module, x: torch.Tensor) -> torch.Tensor:
    """``module``'s conv without its bias at x's dtype: the weight cast to it, the
    output rounded to it (f32 accumulation)."""
    return _conv(module, x, module.weight.to(x.dtype), None)


def conv(module, x: torch.Tensor, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``module`` (a Conv2d or Conv3d) on ``x`` at x's dtype. At the weights' f32 it is
    the module's own conv; below it, as the JAX ``conv2d`` / ``conv3d``
    (``multi_view_stereonet_tpu/models/layers.py:43-57,76-86``): the weight cast to x's
    dtype and the conv's output rounded to it (f32 accumulation); then the bias added
    at ``out_dtype`` (x's by default; the output is cast to it first)."""
    if x.dtype == module.weight.dtype and out_dtype in (None, x.dtype):
        return _conv(module, x, module.weight, module.bias)
    y = _conv_unbiased(module, x).to(out_dtype or x.dtype)
    if module.bias is None:
        return y
    return y + module.bias.to(y.dtype).reshape((-1,) + (1,) * (y.ndim - 2))


def group_norm_leaky(bn: nn.GroupNorm, x, res=None, impl: str = "auto"):
    """leaky_relu(bn(x), 0.2) (+ res), NCHW or NCDHW: ``ops.cuda.gn_apply``'s kernel for
    CUDA tensors; ``impl`` as in ops/cuda/build.py."""
    return group_norm_act(x, bn.weight, bn.bias, bn.num_groups, res, impl)


def conv_group_norm_leaky(module, bn: nn.GroupNorm, x, res=None, impl: str = "auto"):
    """leaky_relu(bn(module(x)), 0.2) (+ res) at x's dtype: below f32 the conv's output
    rounded without its bias, which the GroupNorm adds in f32 (``gn_apply``'s xbias)."""
    if x.dtype == module.weight.dtype:
        return group_norm_leaky(bn, _conv(module, x, module.weight, module.bias), res, impl)
    return group_norm_act(_conv_unbiased(module, x), bn.weight, bn.bias, bn.num_groups, res,
                          impl, xbias=module.bias)


class ResnetBlock(nn.Module):
    """conv3x3 -> GroupNorm -> LeakyReLU(0.2) -> + identity (no final activation)."""

    def __init__(self, channels: int, dilation: int = 1, bias: bool = True):
        super().__init__()
        self.conv1 = conv2d(channels, channels, 3, dilation=dilation, bias=bias)
        self.bn1 = group_norm(channels)

    def forward(self, x, impl: str = "auto"):
        """The tail (GroupNorm, LeakyReLU, + x) is ``group_norm_leaky``; at x's dtype."""
        return conv_group_norm_leaky(self.conv1, self.bn1, x, x, impl)

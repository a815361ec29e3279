"""Closed-form pieces of the backward kernels' plain versions (K2's
``incremental_chain_backward_plain``, K3's ``idepthmap_refiner_backward_plain``): the
GroupNorm + LeakyReLU forward at a kernel's rounding points and its backward, and a 3x3
conv's input and weight gradients. Layout NHWC, (N, h, w, 32) maps; statistics (N, 2, 4),
each group's (mean, rstd).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import precision

GROUPS, SLOPE, GN_EPS = 4, 0.2, 1e-5  # the refiners' GroupNorms and LeakyReLU


def _operand_round(dtype: torch.dtype, tf32: bool):
    """How the kernel's convs round an f32 operand: to bf16 at bf16 storage, to TF32 in
    the 1xTF32 variant, not at all in 3xTF32 (exact f32); the gradient passed straight
    through."""
    if dtype == torch.bfloat16:
        return lambda x: x.to(torch.bfloat16).float()
    return precision.round_tf32 if tf32 else (lambda x: x)


class _GradRound(torch.autograd.Function):
    """The identity, its gradient rounded by ``rnd``: put on a conv's output, autograd's
    conv backward takes the output gradient rounded as the closed form's ``_conv_grads``
    rounds it."""

    @staticmethod
    def forward(ctx, x, rnd):
        ctx.rnd = rnd
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.rnd(g), None


def _round_to(dtype: torch.dtype, x: torch.Tensor) -> torch.Tensor:
    """x (f32) rounded to the storage ``dtype``, kept in f32."""
    return x if dtype == torch.float32 else x.to(dtype).float()


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _gn_forward(raw: torch.Tensor, stat: torch.Tensor, gamma: torch.Tensor,
                beta: torch.Tensor):
    """x_hat and the GroupNorm value z = x_hat gamma + beta of raw (N, h, w, 32) from the
    statistics stat (N, 2, 4) (mean, rstd of each group), in the kernel's order."""
    N, h, w, C = raw.shape
    g = raw.reshape(N, h, w, GROUPS, C // GROUPS)
    xhat = ((g - stat[:, 0, None, None, :, None]) * stat[:, 1, None, None, :, None])
    xhat = xhat.reshape(N, h, w, C)
    return xhat, xhat * gamma + beta


def _leaky(z: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """LeakyReLU(0.2) of an f32 value, rounded to the storage dtype; autograd takes
    ``_leaky_slope``'s derivative through it (at f32 ``F.leaky_relu``'s, 0.2 at 0)."""
    if dtype == torch.float32:
        return F.leaky_relu(z, SLOPE)
    return _round_to(dtype, torch.where(z >= 0, z, SLOPE * z))


def _leaky_slope(z: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """LeakyReLU's derivative at the f32 GroupNorm value z, as plain autograd takes it: at
    f32 ``F.leaky_relu``'s (0.2 at 0), at bf16 the JAX-style ``where`` on z rounded (1 at 0)."""
    if dtype == torch.float32:
        return torch.where(z > 0, 1.0, SLOPE)
    return torch.where(_round_to(dtype, z) >= 0, 1.0, SLOPE)


def _group_stats(x: torch.Tensor) -> torch.Tensor:
    """(N, 2, 4) f32 mean and rstd of each group of x (N, h, w, 32), one pass in f64 with
    the variance clamped at 0, as the kernels' sums compute them."""
    N = x.shape[0]
    v = x.double().reshape(N, -1, GROUPS, x.shape[-1] // GROUPS).transpose(1, 2)
    v = v.reshape(N, GROUPS, -1)
    mean = v.mean(-1)
    var = ((v * v).mean(-1) - mean * mean).clamp_min(0.0)
    return torch.stack([mean, 1.0 / torch.sqrt(var + GN_EPS)], 1).float()


def _gn_backward(g: torch.Tensor, z: torch.Tensor, xhat: torch.Tensor, stat: torch.Tensor,
                 gamma: torch.Tensor, dtype: torch.dtype) -> tuple:
    """GroupNorm + LeakyReLU's backward: (d raw, d gamma, d beta) from the output's
    gradient g (N, h, w, 32), sums over the map in f64."""
    N, h, w, C = g.shape
    gz = g * _leaky_slope(z, dtype)
    s1 = gz.double().sum((1, 2))  # (N, C): sum of gz, and of gz x_hat
    s2 = (gz * xhat).double().sum((1, 2))
    n = h * w * (C // GROUPS)
    a = (s1 * gamma.double()).reshape(N, GROUPS, -1).sum(-1) / n  # (N, groups)
    b = (s2 * gamma.double()).reshape(N, GROUPS, -1).sum(-1) / n
    per = C // GROUPS
    a = a.float().repeat_interleave(per, -1)[:, None, None]
    b = b.float().repeat_interleave(per, -1)[:, None, None]
    rstd = stat[:, 1].repeat_interleave(per, -1)[:, None, None]
    dx = rstd * (gz * gamma - a - xhat * b)
    return dx, s2.sum(0).float(), s1.sum(0).float()


def _conv_grads(x: torch.Tensor, weight: torch.Tensor, g: torch.Tensor, rnd,
                dilation: int = 1) -> tuple:
    """(d input, d weight) of a 3x3 "same" conv of x (N, h, w, Cin) with an OIHW weight at
    ``dilation``, given its output's gradient g (N, h, w, Cout), each operand rounded by
    ``rnd``."""
    gx, gw, _ = torch.ops.aten.convolution_backward(
        _nchw(rnd(g)).contiguous(), _nchw(rnd(x)).contiguous(), rnd(weight), None, [1, 1],
        [dilation, dilation], [dilation, dilation], False, [0, 0], 1, [True, True, False])
    return gx.permute(0, 2, 3, 1), gw

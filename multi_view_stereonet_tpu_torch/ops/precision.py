"""The convs' matmul precision: a scope that sets it, and the conv that carries it.

The JAX forward wraps its stages in ``jax.default_matmul_precision``; here a stage runs
inside ``scope(mode)``:

- "ieee": exact f32. cuDNN's TF32 is off (``torch.backends.cudnn.allow_tf32``), and
  the hand-written kernels take their f32 (3xTF32) variant;
- "tf32": the convs at TF32. cuDNN's TF32 is on, and K2 and K3 take their 1xTF32
  variant;
- "tf32_round": exact f32 of the conv operands rounded to TF32 as the kernels round
  them (``round_tf32``): the plain versions of the 1xTF32 kernels, deterministic and
  on the CPU too.

Every scope keeps cuBLAS's TF32 (``torch.backends.cuda.matmul.allow_tf32``) off: the
forward's matmuls (the resizes, the soft-argmin, the homographies) are the ones the
JAX package pins to "highest". A scope restores the caller's flags when it closes.
The flags are the process's, not the thread's: a forward in another thread sees
them (the streaming runner's decode threads run no convs). Only the legacy flag
API is used; torch refuses to read it once the two cuDNN flags of the newer
``fp32_precision`` API differ.

Autograd runs a conv's backward after the scope has closed, so ``convolution``
carries its scope's mode into its backward (``_Convolution``) when autograd records:
its weight and input gradients are computed at the forward's precision, as JAX's
transposed dots keep theirs. Outside every scope a conv runs at the caller's flags.

``torch.export`` records no flag, so a serving artifact runs under one scope, its
ambient mode (``checkpoint/export.py``). While ``exporting(ambient)`` traces, a conv
whose scope's mode is another goes into the graph as the custom op
``mvs_torch::convolution``, which carries its mode (``tf32``) and runs in that scope;
every other conv stays an aten convolution. The eager path never calls the op: the
dispatcher costs ~20 us of host a call (PERF.md).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

MODES = ("ieee", "tf32", "tf32_round")

_mode = None  # the innermost open scope's mode, None outside every scope
_artifact_mode = None  # the ambient mode of the artifact ``exporting`` traces


def current():
    """The mode of the innermost open scope, or None outside every scope."""
    return _mode


class scope:
    """``with scope(mode):`` runs its body at ``mode`` (one of ``MODES``); see the module
    docstring. Nests; each scope restores what it found."""

    __slots__ = ("mode", "saved")

    def __init__(self, mode: str):
        if mode not in MODES:
            raise ValueError(f"precision mode must be one of {MODES}, got {mode!r}")
        self.mode = mode

    def __enter__(self):
        global _mode
        self.saved = (_mode, torch.backends.cudnn.allow_tf32,
                      torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = self.mode == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = False
        _mode = self.mode
        return self

    def __exit__(self, *exc):
        global _mode
        _mode, torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = (
            self.saved)
        return False


class exporting:
    """``with exporting(ambient):`` around ``torch.export`` of a program that will run
    in ``scope(ambient)``: the convs at another mode are recorded with it (see the
    module docstring)."""

    __slots__ = ("mode", "saved")

    def __init__(self, mode: str):
        if mode not in MODES:
            raise ValueError(f"precision mode must be one of {MODES}, got {mode!r}")
        self.mode = mode

    def __enter__(self):
        global _artifact_mode
        self.saved, _artifact_mode = _artifact_mode, self.mode
        return self

    def __exit__(self, *exc):
        global _artifact_mode
        _artifact_mode = self.saved
        return False


def tf32_bits(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32 (10 mantissa bits, half away from zero) on its integer
    bits, as the kernels' ``split`` computes its high part: no gradient."""
    bits = x.detach().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``tf32_bits`` of an f32 ``x`` (other dtypes as they are), with the gradient passed
    straight through."""
    if x.dtype != torch.float32:
        return x
    hi = tf32_bits(x)
    return hi if not x.requires_grad else x + (hi - x).detach()


def _conv(x, weight, bias, stride, padding, dilation, groups):
    fn = F.conv2d if weight.ndim == 4 else F.conv3d
    return fn(x, weight, bias, stride, padding, dilation, groups)


@torch.library.custom_op("mvs_torch::convolution", mutates_args=(),
                         device_types=("cpu", "cuda"))
def _recorded_convolution(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
                          stride: list[int], padding: list[int], dilation: list[int],
                          groups: int, tf32: bool) -> torch.Tensor:
    """A conv in ``scope("tf32" if tf32 else "ieee")``: an artifact's conv whose mode is
    not the artifact's ambient one."""
    with scope("tf32" if tf32 else "ieee"):
        return _conv(x, weight, bias, stride, padding, dilation, groups)


@_recorded_convolution.register_fake
def _(x, weight, bias, stride, padding, dilation, groups, tf32):
    return _conv(x, weight, bias, stride, padding, dilation, groups)


def _conv_backward(grad, x, weight, bias_shape, stride, padding, dilation, groups, mask):
    return torch.ops.aten.convolution_backward(
        grad, x, weight, bias_shape, stride, padding, dilation, False,
        [0] * (weight.ndim - 2), groups, mask)


class _Convolution(torch.autograd.Function):
    """A conv whose forward and backward each run in ``scope(mode)``."""

    @staticmethod
    def forward(ctx, mode, x, weight, bias, stride, padding, dilation, groups):
        ctx.mode, ctx.args = mode, (stride, padding, dilation, groups)
        ctx.bias_shape = None if bias is None else bias.shape
        ctx.save_for_backward(x, weight)
        with scope(mode):
            return _conv(x, weight, bias, stride, padding, dilation, groups)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        stride, padding, dilation, groups = ctx.args
        mask = [ctx.needs_input_grad[1], ctx.needs_input_grad[2],
                ctx.bias_shape is not None and ctx.needs_input_grad[3]]
        with scope(ctx.mode):
            gx, gw, gb = _conv_backward(grad, x, weight, ctx.bias_shape, stride, padding,
                                        dilation, groups, mask)
        return None, gx, gw, gb, None, None, None, None


def convolution(x, weight, bias, stride, padding, dilation, groups=1):
    """``F.conv2d`` / ``F.conv3d`` (by the weight's rank) at the open scope's mode: its
    backward at that mode too when autograd records; "tf32_round" rounds x and the
    weight first and is then exact; while ``exporting`` another mode, the custom op
    that records it. Outside every scope, the plain call."""
    mode = _mode
    if mode is None:
        return _conv(x, weight, bias, stride, padding, dilation, groups)
    if mode == "tf32_round":
        x, weight, mode = round_tf32(x), round_tf32(weight), "ieee"
    if _artifact_mode not in (None, mode) and torch.compiler.is_exporting():
        return _recorded_convolution(x, weight, bias, list(stride), list(padding),
                                     list(dilation), groups, mode == "tf32")
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, weight, bias)):
        return _Convolution.apply(mode, x, weight, bias, stride, padding, dilation, groups)
    return _conv(x, weight, bias, stride, padding, dilation, groups)

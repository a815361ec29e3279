"""GroupNorm -> LeakyReLU(0.2) -> optional residual add: CUDA kernel
(csrc/gn_apply.cu) and its plain version. Every GroupNorm of the serving
forward on the card goes through it: the resblock tails (with the residual),
the refiners' ``bn0`` and the cost filter's four (without).

Port of the TPU kernel ``multi_view_stereonet_tpu/ops/pallas/gn_apply.py``
(``gn_apply_residual_fused``) together with the statistics it takes from
``models/s2d.py`` ``gn_s2d_stats``: one call computes the statistics of x
(a statistics pass over chunks of each (sample, group) row) and applies them
(an apply pass). Layout NCHW or NCDHW (the port's modules' own), f32, eps
1e-5 (the port's ``GroupNorm(C // 8)``). Under autograd the kernel runs in
``_GroupNormAct``, whose backward recomputes ``group_norm_act_plain`` as the
JAX ``_bwd`` (``gn_apply.py:120-126``) takes the VJP of ``_xla_reference``
(see recompute.py).
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from .build import check_status, custom_op, load_library, tracing, use_kernel
from .recompute import needs_autograd, plain_vjp

# Kernel launches since the last reset; only the kernel path counts, one per call.
launches = 0

EPS = 1e-5
SLOPE = 0.2
# The statistics pass aims at BLOCKS_PER_SM blocks per SM in all and gives each at
# least MIN_CHUNK elements of its row.
BLOCKS_PER_SM = 4
MIN_CHUNK = 4096

_ARGS = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
         + [ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_void_p])
# Per device index: (SM count, ctypes entry).
_device_cache: dict = {}


def group_norm_act_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                         groups: int, res: torch.Tensor | None = None) -> torch.Tensor:
    """leaky_relu(group_norm(x), 0.2) (+ res), as ``nn.GroupNorm`` computes it."""
    y = F.leaky_relu(F.group_norm(x, groups, weight, bias, EPS), SLOPE)
    return y if res is None else y + res


def chunking(rows: int, L: int, target_blocks: int) -> tuple:
    """(chunk, chunks): each of ``rows`` rows of L floats cut into chunks of a multiple
    of 4 elements, about ``target_blocks`` in all, none under MIN_CHUNK unless the row
    is; chunks * chunk >= L and no chunk is empty."""
    chunks = max(1, min(-(-target_blocks // rows), -(-L // MIN_CHUNK)))
    chunk = -(-L // chunks)
    chunk = -(-chunk // 4) * 4
    return chunk, -(-L // chunk)


def _device_functions(device: int) -> tuple:
    info = _device_cache.get(device)
    if info is None:
        fn = load_library("gn_apply").mvs_gn_act_f32
        fn.argtypes, fn.restype = _ARGS, ctypes.c_int
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        info = _device_cache[device] = (sms, fn)
    return info


def _output(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
            res: torch.Tensor | None, groups: int) -> torch.Tensor:
    """Check the inputs' devices, types and shapes; allocate the (contiguous) output."""
    tensors = (x, weight, bias) if res is None else (x, weight, bias, res)
    if any(t.device != x.device for t in tensors):
        raise ValueError("group_norm_act_kernel needs x, weight, bias (and res) on one "
                         "device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("group_norm_act_kernel takes float32 tensors")
    C = x.shape[1] if x.ndim >= 3 else 0
    if (x.ndim not in (4, 5) or (res is not None and res.shape != x.shape) or groups < 1
            or C % groups or weight.shape != (C,) or bias.shape != (C,)):
        raise ValueError(f"bad shapes: x {tuple(x.shape)}, res "
                         f"{None if res is None else tuple(res.shape)}, weight "
                         f"{tuple(weight.shape)}, bias {tuple(bias.shape)}, groups {groups}")
    return x.new_empty(x.shape)


def _group_norm_act_launch(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                           res: torch.Tensor | None, groups: int) -> torch.Tensor:
    """Launch csrc/gn_apply.cu (a statistics pass, then an apply pass) on CUDA
    tensors. A launch the card refuses raises."""
    global launches
    out = _output(x, weight, bias, res, groups)
    if not x.is_contiguous():
        x = x.contiguous()
    if res is not None and not res.is_contiguous():
        res = res.contiguous()
    if not (weight.is_contiguous() and bias.is_contiguous()):
        weight, bias = weight.contiguous(), bias.contiguous()
    dev = x.get_device()
    N, C, span = x.shape[0], x.shape[1], math.prod(x.shape[2:])
    L = C // groups * span
    ptrs = [x.data_ptr(), out.data_ptr()] + ([] if res is None else [res.data_ptr()])
    vec = 4 if span % 4 == 0 and not any(p % 16 for p in ptrs) else 1
    sms, fn = _device_functions(dev)
    chunk, chunks = chunking(N * groups, L, BLOCKS_PER_SM * sms)
    partials = torch.empty((N * groups, chunks, 2), dtype=torch.float64, device=x.device)
    status = fn(x.data_ptr(), None if res is None else res.data_ptr(), weight.data_ptr(),
                bias.data_ptr(), out.data_ptr(), partials.data_ptr(), N, C, groups, span,
                chunk, chunks, vec, EPS, torch._C._cuda_getCurrentRawStream(dev))
    check_status("mvs_gn_act_f32", status)
    launches += 1
    return out


_group_norm_act_op = custom_op("group_norm_act", "gn_apply")(_group_norm_act_launch)
_group_norm_act_op.register_fake(_output)
# On the CPU the op is the plain version, so that torch.library.opcheck runs there too;
# the wrappers send CPU tensors to the plain version directly.
_group_norm_act_op.register_kernel("cpu")(
    lambda x, weight, bias, res, groups: group_norm_act_plain(x, weight, bias, groups, res))


def _launch(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int,
            res: torch.Tensor | None) -> torch.Tensor:
    """The kernel on CUDA tensors; while ``torch.export`` traces, through the custom op
    ``mvs_torch::group_norm_act`` (see build.py ``custom_op``)."""
    if not x.is_cuda:
        raise ValueError("group_norm_act_kernel needs x, weight, bias (and res) on one "
                         "CUDA device")
    return (_group_norm_act_op if tracing() else _group_norm_act_launch)(
        x, weight, bias, res, groups)


class _GroupNormAct(torch.autograd.Function):
    """K4 under autograd: the kernel forward; the backward recomputes the plain version."""

    @staticmethod
    def forward(ctx, x, weight, bias, res, groups):
        ctx.groups = groups
        ctx.save_for_backward(x, weight, bias, res)
        return _launch(x, weight, bias, groups, res)

    @staticmethod
    def backward(ctx, grad):
        def plain(x, weight, bias, res):
            return group_norm_act_plain(x, weight, bias, ctx.groups, res)
        return (*plain_vjp(plain, ctx.saved_tensors, ctx.needs_input_grad[:4], (grad,)), None)


def group_norm_act_kernel(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                          groups: int, res: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel on CUDA tensors: launched directly, or through ``_GroupNormAct`` when
    autograd records (grad mode on and an input requiring grad)."""
    if needs_autograd(x, weight, bias, res):
        return _GroupNormAct.apply(x, weight, bias, res, groups)
    return _launch(x, weight, bias, groups, res)


def group_norm_act(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int,
                   res: torch.Tensor | None = None, impl: str = "auto") -> torch.Tensor:
    """leaky_relu(group_norm(x), 0.2) (+ res) for NCHW or NCDHW f32; the kernel for
    CUDA tensors, the plain version otherwise (see build.py)."""
    if use_kernel(impl, x):
        return group_norm_act_kernel(x, weight, bias, groups, res)
    return group_norm_act_plain(x, weight, bias, groups, res)


def gn_apply_residual(x: torch.Tensor, res: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor, groups: int, impl: str = "auto") -> torch.Tensor:
    """The resblock tail, leaky_relu(group_norm(x), 0.2) + res: ``group_norm_act``'s
    residual case."""
    return group_norm_act(x, weight, bias, groups, res, impl)

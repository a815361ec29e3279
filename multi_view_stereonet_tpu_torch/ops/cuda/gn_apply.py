"""The resblock tail, GroupNorm -> LeakyReLU(0.2) -> + residual: CUDA kernel
(csrc/gn_apply.cu) and its plain version.

Port of the TPU kernel ``multi_view_stereonet_tpu/ops/pallas/gn_apply.py``
(``gn_apply_residual_fused``) together with the statistics it takes from
``models/s2d.py`` ``gn_s2d_stats``: one call computes the statistics of x
and applies them. Layout NCHW (the port's modules' own), f32, eps 1e-5 (the
port's ``GroupNorm(C // 8)``). Forward only.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .build import check_status, load_library, use_kernel

# Kernel launches since the last reset; only the kernel path counts, one per call.
launches = 0

EPS = 1e-5
SLOPE = 0.2
# The statistics pass aims at BLOCKS_PER_SM blocks per SM in all and gives each at
# least MIN_CHUNK elements of its row.
BLOCKS_PER_SM = 4
MIN_CHUNK = 4096


def gn_apply_residual_plain(x: torch.Tensor, res: torch.Tensor, weight: torch.Tensor,
                            bias: torch.Tensor, groups: int) -> torch.Tensor:
    """leaky_relu(group_norm(x), 0.2) + res, as ``nn.GroupNorm`` computes it."""
    return F.leaky_relu(F.group_norm(x, groups, weight, bias, EPS), SLOPE) + res


def _library():
    lib = load_library("gn_apply")
    fn = lib.mvs_gn_apply_residual_f32
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                       + [ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                          ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _chunking(rows: int, L: int, target_blocks: int) -> tuple:
    """(chunk, chunks): each row cut into chunks of a multiple of 4 elements."""
    chunks = max(1, min(-(-target_blocks // rows), -(-L // MIN_CHUNK)))
    chunk = -(-L // chunks)
    chunk = -(-chunk // 4) * 4
    return chunk, -(-L // chunk)


def gn_apply_residual_kernel(x: torch.Tensor, res: torch.Tensor, weight: torch.Tensor,
                             bias: torch.Tensor, groups: int) -> torch.Tensor:
    """Launch csrc/gn_apply.cu (a statistics pass, then an apply pass) on CUDA tensors."""
    global launches
    tensors = (x, res, weight, bias)
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError("gn_apply_residual_kernel needs x, res, weight and bias on one "
                         "CUDA device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("gn_apply_residual_kernel takes float32 tensors")
    if (x.ndim != 4 or res.shape != x.shape or groups < 1 or x.shape[1] % groups
            or weight.shape != (x.shape[1],) or bias.shape != (x.shape[1],)):
        raise ValueError(f"bad shapes: x {tuple(x.shape)}, res {tuple(res.shape)}, weight "
                         f"{tuple(weight.shape)}, bias {tuple(bias.shape)}, groups {groups}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError("the CUDA GroupNorm-apply kernel is forward only")
    N, C, H, W = x.shape
    x = x.contiguous()
    res = res.contiguous()
    weight = weight.contiguous()
    bias = bias.contiguous()
    out = torch.empty_like(x)
    L = (C // groups) * H * W
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    chunk, chunks = _chunking(N * groups, L, BLOCKS_PER_SM * sms)
    partials = torch.empty((N * groups, chunks, 2), dtype=torch.float64, device=x.device)
    vec = 4 if (H * W) % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (x, res, out)) else 1
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = _library().mvs_gn_apply_residual_f32(
        x.data_ptr(), res.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
        partials.data_ptr(), N, C, groups, H * W, chunk, chunks, vec, EPS, stream)
    check_status("mvs_gn_apply_residual_f32", status)
    launches += 1
    return out


def gn_apply_residual(x: torch.Tensor, res: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor, groups: int, impl: str = "auto") -> torch.Tensor:
    """leaky_relu(group_norm(x), 0.2) + res for NCHW f32; the kernel for CUDA
    tensors, the plain version otherwise (see build.py)."""
    if use_kernel(impl, x):
        return gn_apply_residual_kernel(x, res, weight, bias, groups)
    return gn_apply_residual_plain(x, res, weight, bias, groups)

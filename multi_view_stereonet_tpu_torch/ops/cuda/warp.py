"""Bilinear grid sample: the CUDA kernel (csrc/warp.cu) and its plain version.

Port of the TPU band-warp kernel (``multi_view_stereonet_tpu/ops/pallas/
warp_kernel.py``, ``homography_warp_pallas``) and of the XLA gather it is
held against (``multi_view_stereonet_tpu/ops/warp.py:31-79``). Layout:
image NHWC (B, H, W, C), grid (B, ..., 2) normalized (x, y); returns
(sampled (B, ..., C), invalid (B, ...) bool), invalid marking samples
outside [-1, 1] before the border clamp.

Under autograd the kernel runs in ``_GridSample``, whose backward recomputes
the plain version, as the JAX ``_pallas_grid_sample_bwd``
(``warp_kernel.py:396-404``) takes the VJP of the XLA gather (see
recompute.py). The multi-view recipe never reaches it, since the forward's images
and grids carry no gradient; the two-view recipe's losses do (``losses/consistency.py``):
there the sampled image (a right image, an idepth map) and the grid, projected from
predicted idepth, both carry one, at one channel and at three.

A NaN grid coordinate gives NaN in every channel, on both paths, as the JAX gather
does; its invalid flag is computed as for any other coordinate (|NaN| > 1 is false).
"""

from __future__ import annotations

import ctypes

import torch

from .build import check_status, custom_op, load_library, tracing, use_kernel
from .recompute import needs_autograd, plain_vjp

# Kernel launches since the last reset; only the kernel path counts.
launches = 0


def grid_sample_plain(image: torch.Tensor, grid: torch.Tensor,
                      zero_invalid: bool = False):
    """Gather version, in the arithmetic order of the JAX ``grid_sample``."""
    B, H, W, C = image.shape
    out_shape = grid.shape[:-1]
    gx = grid[..., 0].reshape(B, -1)
    gy = grid[..., 1].reshape(B, -1)
    invalid = (gx.abs() > 1.0) | (gy.abs() > 1.0)

    ix = torch.clamp(((gx + 1.0) * W - 1.0) * 0.5, 0.0, W - 1.0)
    iy = torch.clamp(((gy + 1.0) * H - 1.0) * 0.5, 0.0, H - 1.0)
    x0f = torch.floor(ix)
    y0f = torch.floor(iy)
    wx = (ix - x0f)[..., None]
    wy = (iy - y0f)[..., None]
    # The index clamp only matters for a NaN coordinate (a degenerate
    # homography), which must not become an out-of-range gather.
    x0 = x0f.long().clamp(0, W - 1)
    y0 = y0f.long().clamp(0, H - 1)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)

    flat = image.reshape(B, H * W, C)

    def gather(yy, xx):
        idx = (yy * W + xx)[..., None].expand(-1, -1, C)
        return torch.gather(flat, 1, idx)

    top = gather(y0, x0) * (1.0 - wx) + gather(y0, x1) * wx
    bot = gather(y1, x0) * (1.0 - wx) + gather(y1, x1) * wx
    out = top * (1.0 - wy) + bot * wy
    if zero_invalid:
        out = out.masked_fill(invalid[..., None], 0.0)
    return out.reshape(*out_shape, C), invalid.reshape(out_shape)


def _library():
    lib = load_library("warp")
    fn = lib.mvs_grid_sample_f32
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                       + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _outputs(image: torch.Tensor, grid: torch.Tensor):
    """Check the inputs' types and shapes; allocate (out, invalid)."""
    if image.device != grid.device:
        raise ValueError("grid_sample_kernel needs image and grid on one device")
    if image.dtype != torch.float32 or grid.dtype != torch.float32:
        raise TypeError(f"grid_sample_kernel takes float32, got {image.dtype}, {grid.dtype}")
    if image.ndim != 4 or grid.shape[0] != image.shape[0] or grid.shape[-1] != 2:
        raise ValueError(f"bad shapes: image {tuple(image.shape)}, grid {tuple(grid.shape)}")
    out_shape = grid.shape[:-1]
    return (image.new_empty(out_shape + (image.shape[3],)),
            image.new_empty(out_shape, dtype=torch.bool))


def _grid_sample_launch(image: torch.Tensor, grid: torch.Tensor,
                        zero_invalid: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch csrc/warp.cu on CUDA tensors; same contract as the plain version."""
    global launches
    out, invalid = _outputs(image, grid)
    B, H, W, C = image.shape
    M = grid[0, ..., 0].numel()
    image = image.contiguous()
    grid = grid.contiguous()
    stream = torch.cuda.current_stream(image.device).cuda_stream
    status = _library().mvs_grid_sample_f32(
        image.data_ptr(), grid.data_ptr(), out.data_ptr(), invalid.data_ptr(),
        B, H, W, C, M, int(zero_invalid), stream)
    check_status("mvs_grid_sample_f32", status)
    launches += 1
    return out, invalid


_grid_sample_op = custom_op("grid_sample", "warp")(_grid_sample_launch)
_grid_sample_op.register_fake(lambda image, grid, zero_invalid: _outputs(image, grid))
# On the CPU the op is the plain version, so that torch.library.opcheck runs there too;
# the wrappers send CPU tensors to the plain version directly.
_grid_sample_op.register_kernel("cpu")(grid_sample_plain)


def _launch(image: torch.Tensor, grid: torch.Tensor, zero_invalid: bool):
    """The kernel on CUDA tensors; while ``torch.export`` traces, through the custom op
    ``mvs_torch::grid_sample`` (see build.py ``custom_op``)."""
    if not (image.is_cuda and grid.is_cuda):
        raise ValueError("grid_sample_kernel needs image and grid on one CUDA device")
    return (_grid_sample_op if tracing() else _grid_sample_launch)(image, grid, zero_invalid)


class _GridSample(torch.autograd.Function):
    """K1 under autograd: the kernel forward; the backward recomputes the plain version.
    The invalid mask carries no gradient."""

    @staticmethod
    def forward(ctx, image, grid, zero_invalid):
        ctx.zero_invalid = zero_invalid
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(image, grid)
        out, invalid = _launch(image, grid, zero_invalid)
        ctx.mark_non_differentiable(invalid)
        return out, invalid

    @staticmethod
    def backward(ctx, grad, _grad_invalid):
        def plain(image, grid):
            return grid_sample_plain(image, grid, ctx.zero_invalid)
        return (*plain_vjp(plain, ctx.saved_tensors, ctx.needs_input_grad[:2], (grad, None)),
                None)


def grid_sample_kernel(image: torch.Tensor, grid: torch.Tensor,
                       zero_invalid: bool = False):
    """The kernel on CUDA tensors: launched directly, or through ``_GridSample`` when
    autograd records."""
    if needs_autograd(image, grid):
        return _GridSample.apply(image, grid, zero_invalid)
    return _launch(image, grid, zero_invalid)


def grid_sample(image: torch.Tensor, grid: torch.Tensor, zero_invalid: bool = False,
                impl: str = "auto"):
    """Bilinear border-clamped sample; the kernel for CUDA tensors (see build.py)."""
    if use_kernel(impl, image):
        return grid_sample_kernel(image, grid, zero_invalid)
    return grid_sample_plain(image, grid, zero_invalid)

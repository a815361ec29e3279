"""Bilinear grid sample: the CUDA kernel (csrc/warp.cu) and its plain version.

Port of the TPU band-warp kernel (``multi_view_stereonet_tpu/ops/pallas/
warp_kernel.py``, ``homography_warp_pallas``) and of the XLA gather it is
held against (``multi_view_stereonet_tpu/ops/warp.py:31-79``). Layout:
image NHWC (B, H, W, C), grid (B, ..., 2) normalized (x, y); returns
(sampled (B, ..., C), invalid (B, ...) bool), invalid marking samples
outside [-1, 1] before the border clamp.

Under autograd the kernel runs in ``_GridSample``, whose backward launches the
backward kernel (``grid_sample_backward``, counted in ``backward_launches``; its plain
version in closed form is ``grid_sample_backward_plain``). It computes the VJP of the
XLA gather that the JAX ``_pallas_grid_sample_bwd`` (``warp_kernel.py:396-404``)
takes: the image's gradient is the transpose of the four-tap blend, added with f32
atomics in an order that changes from run to run; the grid's goes through the border
clip as ``jnp.clip``'s does, half at an exact tie (``_clip``). The multi-view recipe
never reaches it, since the forward's images and grids carry no gradient; the two-view
recipe's losses do (``losses/consistency.py``): there the sampled image (a right image,
an idepth map) and the grid, projected from predicted idepth, both carry one, at one
channel and at three.

A NaN grid coordinate gives NaN in every channel, on both paths, as the JAX gather
does; its invalid flag is computed as for any other coordinate (|NaN| > 1 is false).

``out_dtype`` (bf16) writes the f32 interpolation rounded once, as the JAX
``homography_warp_auto(out_dtype=)`` and the Pallas kernel's output write
(``warp_kernel.py:224-273``) do: the kernel's bf16 output is its f32 output
rounded. The kernel takes an f32 image; the plain version also samples a bf16
one, interpolating at the image's dtype as the JAX ``grid_sample`` does
(``ops/warp.py:71-74``), which the incremental chain's plain loop needs.
"""

from __future__ import annotations

import ctypes

import torch

from .build import (
    check_status, custom_op, launch_device, load_library, needs_autograd, tracing,
    use_kernel)

# Kernel launches since the last reset; only the kernel path counts. backward_launches
# counts the backward kernel's.
launches = 0
backward_launches = 0


def _clip(u: torch.Tensor, hi: float) -> torch.Tensor:
    """u clipped to [0, hi] as ``jnp.clip`` does it (``multi_view_stereonet_tpu/ops/
    warp.py:26-28``): a maximum, then a minimum, each passing half the gradient at a tie,
    so a coordinate exactly on the border gets half; ``torch.clamp`` would pass all of
    it. The values are ``torch.clamp``'s, NaN included."""
    return torch.minimum(torch.maximum(u, u.new_zeros(())), u.new_full((), hi))


def grid_sample_plain(image: torch.Tensor, grid: torch.Tensor,
                      zero_invalid: bool = False, out_dtype: torch.dtype | None = None):
    """Gather version, in the arithmetic order of the JAX ``grid_sample``; the
    weights and the blend at the image's dtype, the result cast to ``out_dtype``."""
    B, H, W, C = image.shape
    out_shape = grid.shape[:-1]
    gx = grid[..., 0].reshape(B, -1)
    gy = grid[..., 1].reshape(B, -1)
    invalid = (gx.abs() > 1.0) | (gy.abs() > 1.0)

    ix = _clip(((gx + 1.0) * W - 1.0) * 0.5, W - 1.0)
    iy = _clip(((gy + 1.0) * H - 1.0) * 0.5, H - 1.0)
    x0f = torch.floor(ix)
    y0f = torch.floor(iy)
    wx = (ix - x0f)[..., None].to(image.dtype)
    wy = (iy - y0f)[..., None].to(image.dtype)
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
    if out_dtype is not None:
        out = out.to(out_dtype)
    if zero_invalid:
        out = out.masked_fill(invalid[..., None], 0.0)
    return out.reshape(*out_shape, C), invalid.reshape(out_shape)


def _clip_backward(g: torch.Tensor, u: torch.Tensor, hi: float) -> torch.Tensor:
    """The gradient of ``_clip(u, hi)`` given its output's, as autograd takes it through
    the minimum and the maximum: half at a tie, none past a bound, all of it for NaN."""
    m = torch.clamp(u, min=0.0)  # the maximum's output (NaN stays NaN)
    g = torch.where(m == hi, g * 0.5, g).masked_fill(m > hi, 0.0)
    return torch.where(u == 0.0, g * 0.5, g).masked_fill(u < 0.0, 0.0)


def grid_sample_backward_plain(image: torch.Tensor, grid: torch.Tensor, grad: torch.Tensor,
                               zero_invalid: bool = False, needs=(True, True)) -> tuple:
    """The gradients (d image, d grid) of ``grid_sample_plain(image, grid, zero_invalid,
    out_dtype)`` at an f32 image, given the output's gradient ``grad`` (f32, or bf16 for
    the bf16 output), in closed form as the backward kernel computes them; None for an
    input that ``needs`` leaves out. The image's is the transpose of the four-tap blend
    (``index_add_``); the grid's is sum_c of the gradient times the blend's derivative in
    wx and wy, through the border clip (``_clip_backward``) and the unnormalization. A
    sample zeroed by ``zero_invalid`` passes no gradient (its weights still multiply:
    a NaN weight gives NaN, as autograd's products do); a NaN coordinate gathers
    pixel (0, 0) and its neighbours, as the forward's index clamp does."""
    B, H, W, C = image.shape
    gx = grid[..., 0].reshape(B, -1)
    gy = grid[..., 1].reshape(B, -1)
    ux = ((gx + 1.0) * W - 1.0) * 0.5
    uy = ((gy + 1.0) * H - 1.0) * 0.5
    ix, iy = _clip(ux, W - 1.0), _clip(uy, H - 1.0)
    x0f, y0f = torch.floor(ix), torch.floor(iy)
    wx, wy = (ix - x0f)[..., None], (iy - y0f)[..., None]
    x0 = x0f.long().clamp(0, W - 1)
    y0 = y0f.long().clamp(0, H - 1)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    g = grad.reshape(B, -1, C).float()
    if zero_invalid:
        invalid = (gx.abs() > 1.0) | (gy.abs() > 1.0)
        g = g.masked_fill(invalid[..., None], 0.0)
    gtop, gbot = g * (1.0 - wy), g * wy
    taps = [(y0, x0, gtop * (1.0 - wx)), (y0, x1, gtop * wx),
            (y1, x0, gbot * (1.0 - wx)), (y1, x1, gbot * wx)]
    base = torch.arange(B, device=image.device)[:, None] * (H * W)
    dimage = dgrid = None
    if needs[0]:
        flat = image.new_zeros(B * H * W, C)
        for yy, xx, v in taps:
            flat.index_add_(0, (base + yy * W + xx).reshape(-1), v.reshape(-1, C))
        dimage = flat.reshape(B, H, W, C)
    if needs[1]:
        src = image.reshape(B * H * W, C)
        v00, v01, v10, v11 = (src[(base + yy * W + xx).reshape(-1)].reshape(B, -1, C)
                              for yy, xx, _ in taps)
        top = v00 * (1.0 - wx) + v01 * wx
        bot = v10 * (1.0 - wx) + v11 * wx
        gwx = (gtop * (v01 - v00) + gbot * (v11 - v10)).sum(-1)
        gwy = (g * (bot - top)).sum(-1)
        dgx = _clip_backward(gwx, ux, W - 1.0) * 0.5 * W
        dgy = _clip_backward(gwy, uy, H - 1.0) * 0.5 * H
        dgrid = torch.stack([dgx, dgy], -1).reshape(grid.shape)
    return dimage, dgrid


# The output dtypes the kernel writes, and each one's entry in csrc/warp.cu.
ENTRIES = {torch.float32: "mvs_grid_sample_f32", torch.bfloat16: "mvs_grid_sample_bf16"}


def _entry(out_dtype: torch.dtype):
    fn = getattr(load_library("warp"), ENTRIES[out_dtype])
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                       + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _outputs(image: torch.Tensor, grid: torch.Tensor,
             out_dtype: torch.dtype = torch.float32):
    """Check the inputs' types and shapes; allocate (out, invalid)."""
    if image.device != grid.device:
        raise ValueError("grid_sample_kernel needs image and grid on one device")
    if image.dtype != torch.float32 or grid.dtype != torch.float32:
        raise TypeError(f"grid_sample_kernel takes float32, got {image.dtype}, {grid.dtype}")
    if out_dtype not in ENTRIES:
        raise TypeError(f"grid_sample_kernel writes float32 or bfloat16, not {out_dtype}")
    if image.ndim != 4 or grid.shape[0] != image.shape[0] or grid.shape[-1] != 2:
        raise ValueError(f"bad shapes: image {tuple(image.shape)}, grid {tuple(grid.shape)}")
    out_shape = grid.shape[:-1]
    return (image.new_empty(out_shape + (image.shape[3],), dtype=out_dtype),
            image.new_empty(out_shape, dtype=torch.bool))


def _grid_sample_launch(image: torch.Tensor, grid: torch.Tensor, zero_invalid: bool,
                        out_dtype: torch.dtype = torch.float32
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch csrc/warp.cu on CUDA tensors; same contract as the plain version."""
    global launches
    out, invalid = _outputs(image, grid, out_dtype)
    B, H, W, C = image.shape
    M = grid[0, ..., 0].numel()
    image = image.contiguous()
    grid = grid.contiguous()
    stream = torch.cuda.current_stream(image.device).cuda_stream
    with launch_device(image.device):
        status = _entry(out_dtype)(
            image.data_ptr(), grid.data_ptr(), out.data_ptr(), invalid.data_ptr(),
            B, H, W, C, M, int(zero_invalid), stream)
    check_status(ENTRIES[out_dtype], status)
    launches += 1
    return out, invalid


_grid_sample_op = custom_op("grid_sample", "warp")(_grid_sample_launch)
_grid_sample_op.register_fake(
    lambda image, grid, zero_invalid, out_dtype=torch.float32: _outputs(image, grid,
                                                                        out_dtype))
# On the CPU the op is the plain version, so that torch.library.opcheck runs there too;
# the wrappers send CPU tensors to the plain version directly.
_grid_sample_op.register_kernel("cpu")(grid_sample_plain)


def _launch(image: torch.Tensor, grid: torch.Tensor, zero_invalid: bool,
            out_dtype: torch.dtype):
    """The kernel on CUDA tensors; while ``torch.export`` traces, through the custom op
    ``mvs_torch::grid_sample`` (see build.py ``custom_op``)."""
    if not (image.is_cuda and grid.is_cuda):
        raise ValueError("grid_sample_kernel needs image and grid on one CUDA device")
    return (_grid_sample_op if tracing() else _grid_sample_launch)(image, grid, zero_invalid,
                                                                    out_dtype)


# The output gradient's dtypes the backward kernel takes, and each one's entry.
BACKWARD = {torch.float32: "mvs_grid_sample_bwd_f32",
            torch.bfloat16: "mvs_grid_sample_bwd_bf16"}


def grid_sample_backward(image: torch.Tensor, grid: torch.Tensor, grad: torch.Tensor,
                         zero_invalid: bool = False, needs=(True, True)) -> tuple:
    """The backward kernel of csrc/warp.cu on CUDA tensors: (d image, d grid) f32, None
    for an input that ``needs`` leaves out; the contract of
    ``grid_sample_backward_plain``. The image's gradient is zeroed on the stream, then
    the kernel adds each sample's four taps into it."""
    global backward_launches
    if not (image.is_cuda and grid.device == image.device and grad.device == image.device):
        raise ValueError("grid_sample_backward needs image, grid and grad on one CUDA device")
    if image.dtype != torch.float32 or grid.dtype != torch.float32 or grad.dtype not in BACKWARD:
        raise TypeError(f"grid_sample_backward takes an f32 image and grid and an f32 or bf16 "
                        f"gradient, got {image.dtype}, {grid.dtype}, {grad.dtype}")
    B, H, W, C = image.shape
    if grid.shape[0] != B or grid.shape[-1] != 2 or grad.shape != grid.shape[:-1] + (C,):
        raise ValueError(f"bad shapes: image {tuple(image.shape)}, grid {tuple(grid.shape)}, "
                         f"grad {tuple(grad.shape)}")
    image, grid, grad = image.contiguous(), grid.contiguous(), grad.contiguous()
    dimage = torch.zeros_like(image) if needs[0] else None
    dgrid = torch.empty_like(grid) if needs[1] else None
    if dimage is None and dgrid is None:
        return None, None
    fn = getattr(load_library("warp"), BACKWARD[grad.dtype])
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                       + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(image.device).cuda_stream
    with launch_device(image.device):
        status = fn(image.data_ptr(), grid.data_ptr(), grad.data_ptr(),
                    0 if dimage is None else dimage.data_ptr(),
                    0 if dgrid is None else dgrid.data_ptr(),
                    B, H, W, C, grid[0, ..., 0].numel(), int(zero_invalid), stream)
    check_status(BACKWARD[grad.dtype], status)
    backward_launches += 1
    return dimage, dgrid


class _GridSample(torch.autograd.Function):
    """K1 under autograd: the kernel forward; the backward kernel (``grid_sample_backward``)
    for the gradients asked for. The invalid mask carries no gradient."""

    @staticmethod
    def forward(ctx, image, grid, zero_invalid, out_dtype):
        ctx.zero_invalid, ctx.out_dtype = zero_invalid, out_dtype
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(image, grid)
        out, invalid = _launch(image, grid, zero_invalid, out_dtype)
        ctx.mark_non_differentiable(invalid)
        return out, invalid

    @staticmethod
    def backward(ctx, grad, _grad_invalid):
        if grad is None:
            return None, None, None, None
        image, grid = ctx.saved_tensors
        return (*grid_sample_backward(image, grid, grad, ctx.zero_invalid,
                                      ctx.needs_input_grad[:2]), None, None)


def grid_sample_kernel(image: torch.Tensor, grid: torch.Tensor,
                       zero_invalid: bool = False, out_dtype: torch.dtype | None = None):
    """The kernel on CUDA tensors: launched directly, or through ``_GridSample`` when
    autograd records."""
    out_dtype = out_dtype or image.dtype
    if needs_autograd(image, grid):
        return _GridSample.apply(image, grid, zero_invalid, out_dtype)
    return _launch(image, grid, zero_invalid, out_dtype)


def grid_sample(image: torch.Tensor, grid: torch.Tensor, zero_invalid: bool = False,
                impl: str = "auto", out_dtype: torch.dtype | None = None):
    """Bilinear border-clamped sample, written at ``out_dtype`` (the image's by
    default); the kernel for CUDA tensors (see build.py)."""
    if use_kernel(impl, image):
        return grid_sample_kernel(image, grid, zero_invalid, out_dtype)
    return grid_sample_plain(image, grid, zero_invalid, out_dtype)

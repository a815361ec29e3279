"""The incremental feature chain: CUDA kernel (csrc/incremental_chain.cu) and plain loop.

Port of the TPU kernel ``multi_view_stereonet_tpu/ops/pallas/
incremental_chain.py`` (``incremental_chain_fused``) and of the scan it is
held against, ``_incremental_scan`` (``multi_view_stereonet_tpu/models/
mvsnet.py:218-234``). For each hypothesis step the previous features are
warped by the incremental homography, invalid samples are zeroed, and the
FeatureRefiner adds its delta.

Layouts (the JAX package's): feats0 (N, h, w, 32), image_rest
(N, D-1, h, w, 3), H_inc (N, D-1, 3, 3) -> (N, D, h, w, 32) with
hypothesis 0 = feats0. The refiner is the port's ``FeatureRefiner``
module (NCHW inside). The chain runs at feats0's dtype, f32 or bf16, and
image_rest is cast to it (``_incremental_scan``: ``image_i.astype(warped.dtype)``).
At bf16 the plain loop is the scan at bf16 (its warp interpolates at bf16, as
the JAX ``grid_sample`` does), and the kernel follows the Pallas kernel's
rounding points (``incremental_chain.py:82-174``): the warp interpolates the bf16
carry in f32 and rounds once, each GroupNorm + LeakyReLU rounds its f32 result,
the residual and the step's output are rounded sums; the convs take bf16
operands and accumulate in f32. Under autograd the kernel runs in ``_IncrementalChain``,
which takes the refiner's weights as inputs and whose backward recomputes the
plain loop, as the JAX ``_chain_bwd`` (``incremental_chain.py:357-368``)
recomputes ``_incremental_scan`` (see recompute.py).

At f32 storage the kernel has two variants: 3xTF32 (exact f32, the default) and 1xTF32
(``tf32``: one product of the TF32-rounded operands), which ``incremental_chain`` takes
inside a "tf32" precision scope (``ops/precision.py``; the "chain" stage at
``matmul_precision: high``). Its plain version is ``incremental_chain_tf32_plain``: the
loop with each conv operand rounded to TF32 as the kernel rounds it, then exact.
"""

from __future__ import annotations

import ctypes

import torch

from .. import precision
from .build import (
    check_status, custom_op, launch_device, load_library, tracing, use_kernel)
from .recompute import bind_parameters, needs_autograd, plain_vjp
from .warp import grid_sample_plain
from ..warp import homography_grid

# Kernel launches since the last reset; only the kernel path counts. tf32_launches
# counts those of the 1xTF32 variant among them.
launches = 0
tf32_launches = 0


def incremental_chain_plain(refiner, feats0: torch.Tensor, image_rest: torch.Tensor,
                            H_inc: torch.Tensor) -> torch.Tensor:
    """Python loop over the hypotheses, in the order of ``_incremental_scan``, at
    feats0's dtype; the refiner runs on its plain version too, so this path launches
    no kernel."""
    h, w = feats0.shape[1], feats0.shape[2]
    feats = feats0
    volume = [feats0]
    for d in range(H_inc.shape[1]):
        grid = homography_grid(H_inc[:, d], h, w)
        warped, _ = grid_sample_plain(feats, grid, zero_invalid=True)
        image = image_rest[:, d].permute(0, 3, 1, 2).to(feats0.dtype)
        refined = refiner(image, warped.permute(0, 3, 1, 2), impl="plain")
        feats = refined.permute(0, 2, 3, 1).contiguous()
        volume.append(feats)
    return torch.stack(volume, dim=1)


def incremental_chain_tf32_plain(refiner, feats0: torch.Tensor, image_rest: torch.Tensor,
                                 H_inc: torch.Tensor) -> torch.Tensor:
    """The plain version of the 1xTF32 kernel: ``incremental_chain_plain`` with each conv
    operand (the staged input, the weights) rounded to TF32 as the kernel's ``split``
    rounds it, then computed in f32 (``precision.scope("tf32_round")``)."""
    with precision.scope("tf32_round"):
        return incremental_chain_plain(refiner, feats0, image_rest, H_inc)


# The storage dtypes the kernel takes, and each one's entry in csrc/incremental_chain.cu;
# TF32_ENTRY is the f32 storage's 1xTF32 variant.
ENTRIES = {torch.float32: "mvs_incremental_chain_f32",
           torch.bfloat16: "mvs_incremental_chain_bf16"}
TF32_ENTRY = "mvs_incremental_chain_tf32"


def _entry(dtype: torch.dtype, tf32: bool) -> str:
    """The kernel entry for storage ``dtype``: 1xTF32 where ``tf32`` and the storage is
    f32; bf16 storage takes its bf16 variant at every precision."""
    return TF32_ENTRY if tf32 and dtype == torch.float32 else ENTRIES[dtype]


def _library():
    lib = load_library("incremental_chain")
    if lib.mvs_incremental_chain_f32.argtypes is None:
        for name in (*ENTRIES.values(), TF32_ENTRY):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        query = lib.mvs_incremental_chain_cluster
        query.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
        query.restype = ctypes.c_int
    return lib


def cluster_size(n: int, h: int, w: int, device=None) -> int:
    """The blocks a sample the kernel takes for n samples of an h x w map on ``device``
    (the current CUDA device by default): 16, or 8 where that needs fewer waves."""
    size = ctypes.c_int(0)
    with torch.cuda.device(device):
        check_status("mvs_incremental_chain_cluster",
                     _library().mvs_incremental_chain_cluster(n, h, w, ctypes.byref(size)))
    return size.value


def _taps(weight: torch.Tensor) -> torch.Tensor:
    """OIHW 3x3 conv weight -> (9, Cin, Cout) tap-major, contiguous."""
    return weight.permute(2, 3, 1, 0).reshape(9, weight.shape[1], weight.shape[0]).contiguous()


def _output(feats0: torch.Tensor, image_rest: torch.Tensor, H_inc: torch.Tensor,
            w0: torch.Tensor, wr: torch.Tensor, wf: torch.Tensor,
            vec: torch.Tensor) -> torch.Tensor:
    """Check the inputs' devices, types and shapes; allocate the (N, D, h, w, 32) output
    at feats0's dtype."""
    tensors = (feats0, image_rest, H_inc, w0, wr, wf, vec)
    if any(t.device != feats0.device for t in tensors):
        raise ValueError("incremental_chain_kernel needs every tensor and weight on one "
                         "device")
    if (feats0.dtype not in ENTRIES or image_rest.dtype != feats0.dtype
            or any(t.dtype != torch.float32 for t in tensors[2:])):
        raise TypeError("incremental_chain_kernel takes feats0 and image_rest of one dtype, "
                        "float32 or bfloat16, and float32 homographies and weights")
    N, h, w, C = feats0.shape
    Dm1 = H_inc.shape[1]
    if (C != 32 or w0.shape != (9, 35, 32) or wr.shape != (9, 32, 32)
            or wf.shape != (9, 32, 32) or vec.shape != (7, 32)
            or image_rest.shape != (N, Dm1, h, w, 3) or H_inc.shape != (N, Dm1, 3, 3)):
        raise ValueError(f"bad shapes: feats0 {tuple(feats0.shape)}, image_rest "
                         f"{tuple(image_rest.shape)}, H_inc {tuple(H_inc.shape)}, conv0 "
                         f"taps {tuple(w0.shape)}")
    return feats0.new_empty((N, Dm1 + 1, h, w, C))


def _incremental_chain_launch(feats0: torch.Tensor, image_rest: torch.Tensor,
                              H_inc: torch.Tensor, w0: torch.Tensor, wr: torch.Tensor,
                              wf: torch.Tensor, vec: torch.Tensor,
                              cluster: int, tf32: bool = False) -> torch.Tensor:
    """Launch csrc/incremental_chain.cu: one thread-block cluster per sample runs all D-1
    steps, at feats0's dtype (f32 storage: 1xTF32 where ``tf32``, else 3xTF32). The
    refiner's conv weights come as f32 taps (``_taps``; the bf16 kernel rounds them to
    bf16 as it loads them), its seven bias and GroupNorm vectors stacked in ``vec``."""
    global launches, tf32_launches
    out = _output(feats0, image_rest, H_inc, w0, wr, wf, vec)
    N, h, w, C = feats0.shape
    feats0 = feats0.contiguous()
    if feats0.data_ptr() % 16:  # the kernel reads it as float4
        feats0 = feats0.clone()
    image_rest, H_inc = image_rest.contiguous(), H_inc.contiguous()
    w0, wr, wf, vec = w0.contiguous(), wr.contiguous(), wf.contiguous(), vec.contiguous()
    scratch = torch.empty((N, 3, h, w, C), dtype=torch.float32, device=feats0.device)
    stream = torch.cuda.current_stream(feats0.device).cuda_stream
    entry = _entry(feats0.dtype, tf32)
    with launch_device(feats0.device):
        status = getattr(_library(), entry)(
            feats0.data_ptr(), image_rest.data_ptr(), H_inc.data_ptr(), w0.data_ptr(),
            wr.data_ptr(), wf.data_ptr(), vec.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), N, H_inc.shape[1], h, w, cluster, stream)
    check_status(entry, status)
    launches += 1
    tf32_launches += entry == TF32_ENTRY
    return out


_incremental_chain_op = custom_op("incremental_chain",
                                  "incremental_chain")(_incremental_chain_launch)
_incremental_chain_op.register_fake(
    lambda feats0, image_rest, H_inc, w0, wr, wf, vec, cluster, tf32=False: _output(
        feats0, image_rest, H_inc, w0, wr, wf, vec))


def _launch(refiner, feats0: torch.Tensor, image_rest: torch.Tensor, H_inc: torch.Tensor,
            cluster: int, tf32: bool) -> torch.Tensor:
    """The kernel on CUDA tensors; while ``torch.export`` traces, through the custom op
    ``mvs_torch::incremental_chain`` (see build.py ``custom_op``). ``cluster`` sets the blocks a sample (0: the kernel chooses, see ``cluster_size``); a
    size the card refuses raises."""
    if not feats0.is_cuda:
        raise ValueError("incremental_chain_kernel needs every tensor and weight "
                         "on one CUDA device")
    res = refiner.res0
    vec = torch.stack([refiner.conv0.bias, refiner.bn0.weight, refiner.bn0.bias,
                       res.conv1.bias, res.bn1.weight, res.bn1.bias,
                       refiner.conv_final.bias])
    launch = _incremental_chain_op if tracing() else _incremental_chain_launch
    return launch(feats0, image_rest.to(feats0.dtype), H_inc, _taps(refiner.conv0.weight),
                  _taps(res.conv1.weight), _taps(refiner.conv_final.weight), vec, cluster,
                  tf32)


class _IncrementalChain(torch.autograd.Function):
    """K2 under autograd: the kernel forward, given the refiner's weights as inputs so
    that autograd routes their gradients; the backward recomputes the plain loop with
    those weights. At bf16 the two round at different points: the kernel warps in f32
    as the Pallas kernel does, the recompute warps at bf16 as the JAX scan does. So the
    gradient is that of the scan at the saved inputs, not of the kernel's own forward,
    exactly as the JAX custom VJP (``incremental_chain.py:351-371``) differentiates
    ``_incremental_scan`` under the Pallas forward. The recompute's convs run at the
    forward's precision: under cuDNN's TF32 after the 1xTF32 variant, exact otherwise."""

    @staticmethod
    def forward(ctx, refiner, names, cluster, tf32, feats0, image_rest, H_inc, *params):
        ctx.refiner, ctx.names, ctx.tf32 = refiner, names, tf32
        ctx.save_for_backward(feats0, image_rest, H_inc, *params)
        return _launch(refiner, feats0, image_rest, H_inc, cluster, tf32)

    @staticmethod
    def backward(ctx, grad):
        def plain(feats0, image_rest, H_inc, *params):
            return incremental_chain_plain(bind_parameters(ctx.refiner, ctx.names, params),
                                           feats0, image_rest, H_inc)
        with precision.scope("tf32" if ctx.tf32 else "ieee"):
            return (None, None, None, None,
                    *plain_vjp(plain, ctx.saved_tensors, ctx.needs_input_grad[4:], (grad,)))


def incremental_chain_kernel(refiner, feats0: torch.Tensor, image_rest: torch.Tensor,
                             H_inc: torch.Tensor, cluster: int = 0,
                             tf32: bool = False) -> torch.Tensor:
    """The kernel on CUDA tensors (``cluster`` as in ``_launch``; ``tf32``: the 1xTF32
    variant at f32 storage): launched directly, or through ``_IncrementalChain`` when
    autograd records."""
    if torch.is_grad_enabled():
        names, params = zip(*refiner.named_parameters())
        if needs_autograd(feats0, image_rest, H_inc, *params):
            return _IncrementalChain.apply(refiner, names, cluster, tf32, feats0, image_rest,
                                           H_inc, *params)
    return _launch(refiner, feats0, image_rest, H_inc, cluster, tf32)


def incremental_chain(refiner, feats0: torch.Tensor, image_rest: torch.Tensor,
                      H_inc: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """The chain at feats0's dtype and at the open precision scope's mode: the kernel for
    CUDA tensors (1xTF32 in a "tf32" scope), the plain loop otherwise, its convs at the
    scope's mode (see build.py and ops/precision.py)."""
    if use_kernel(impl, feats0):
        return incremental_chain_kernel(refiner, feats0, image_rest, H_inc,
                                        tf32=precision.current() == "tf32")
    return incremental_chain_plain(refiner, feats0, image_rest, H_inc)

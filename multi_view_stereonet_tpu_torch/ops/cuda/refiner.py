"""The IDepthmapRefiner of a small level as one CUDA kernel (csrc/idepthmap_refiner.cu),
and its plain version.

Port of the TPU kernel ``multi_view_stereonet_tpu/ops/pallas/refiner_kernel.py``
(``idepthmap_refiner_fused``), whose semantics are ``models/refiners.py``
``idepthmap_refiner``. Layouts are the port's modules': guidance (N, Cg, h, w),
idepthmap (N, h, w), already fx-scaled by the caller -> ReLU(idepthmap + delta)
(N, h, w). The refiner is the port's ``IDepthmapRefiner`` module; its weights are
packed at the call. Forward only.
"""

from __future__ import annotations

import ctypes

import torch

from .build import check_status, load_library, use_kernel
from .incremental_chain import _taps

# Kernel launches since the last reset; only the kernel path counts.
launches = 0

TILE = 64          # pixels per unit of work, csrc/idepthmap_refiner.cu's TILE (it checks)
MAX_CIN0 = 36      # conv0 input channels the kernel's shared memory holds
NUM_RES = 6


def fused_refiner_supported(h: int, w: int, n: int) -> bool:
    """The shape rule for sending a refiner through the kernel: the small levels.

    At 480x640 it selects levels 4 (30x40, n = B*V) and 3 (60x80, n = B), the
    levels the JAX gate selects (``refiner_kernel.py`` ``fused_refiner_supported``;
    its VMEM bound on the padded grid is a TPU limit and is not copied).
    """
    return h * w <= 60 * 80 and n <= 8


def idepthmap_refiner_plain(refiner, guidance: torch.Tensor,
                            idepthmap: torch.Tensor) -> torch.Tensor:
    """The module itself, every piece on its plain PyTorch version."""
    return refiner(guidance, idepthmap, impl="plain")


def _library():
    lib = load_library("idepthmap_refiner")
    fn = lib.mvs_idepthmap_refiner_f32
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_void_p]
                       + [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _pack(refiner):
    """(w0, wr, wf, vec, dilations) in the kernel's layouts."""
    blocks = [getattr(refiner, f"res{i}") for i in range(NUM_RES)]
    w0 = _taps(refiner.conv0.weight)
    wr = torch.stack([_taps(b.conv1.weight) for b in blocks])
    wf = _taps(refiner.conv_final.weight)
    rows = [refiner.conv0.bias, refiner.bn0.weight, refiner.bn0.bias]
    for b in blocks:
        rows += [b.conv1.bias, b.bn1.weight, b.bn1.bias]
    vec = torch.cat([torch.stack(rows).reshape(-1), refiner.conv_final.bias])
    dilations = tuple(b.conv1.dilation[0] for b in blocks)
    return w0, wr, wf, vec, dilations


def idepthmap_refiner_kernel(refiner, guidance: torch.Tensor,
                             idepthmap: torch.Tensor) -> torch.Tensor:
    """Launch csrc/idepthmap_refiner.cu: one cooperative grid runs the whole refiner."""
    global launches
    tensors = (guidance, idepthmap) + tuple(refiner.parameters())
    if not all(t.is_cuda and t.device == guidance.device for t in tensors):
        raise ValueError("idepthmap_refiner_kernel needs every tensor and weight on one "
                         "CUDA device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("idepthmap_refiner_kernel takes float32 tensors and weights")
    if guidance.ndim != 4:
        raise ValueError(f"bad shapes: guidance {tuple(guidance.shape)}")
    N, Cg, h, w = guidance.shape
    if (idepthmap.shape != (N, h, w) or Cg + 1 > MAX_CIN0
            or refiner.conv0.weight.shape != (32, Cg + 1, 3, 3)
            or refiner.conv_final.weight.shape != (1, 32, 3, 3)):
        raise ValueError(f"bad shapes: guidance {tuple(guidance.shape)}, idepthmap "
                         f"{tuple(idepthmap.shape)}, conv0 "
                         f"{tuple(refiner.conv0.weight.shape)}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError("the CUDA idepthmap-refiner kernel is forward only")
    w0, wr, wf, vec, dilations = _pack(refiner)
    guidance = guidance.contiguous()
    idepthmap = idepthmap.contiguous()
    dev = guidance.device
    out = torch.empty((N, h, w), dtype=torch.float32, device=dev)
    scratch = torch.empty((2, N, h * w, 32), dtype=torch.float32, device=dev)
    units = N * -(-(h * w) // TILE)
    partials = torch.empty((units, 4, 2), dtype=torch.float64, device=dev)
    barrier = torch.zeros(1, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    status = _library().mvs_idepthmap_refiner_f32(
        guidance.data_ptr(), idepthmap.data_ptr(), w0.data_ptr(), wr.data_ptr(),
        wf.data_ptr(), vec.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        partials.data_ptr(), units, barrier.data_ptr(), N, Cg + 1, h, w,
        (ctypes.c_int * NUM_RES)(*dilations), stream)
    check_status("mvs_idepthmap_refiner_f32", status)
    launches += 1
    return out


def idepthmap_refiner(refiner, guidance: torch.Tensor, idepthmap: torch.Tensor,
                      impl: str = "auto") -> torch.Tensor:
    """ReLU(idepthmap + refiner delta): the kernel for CUDA tensors, the module's
    plain version otherwise (see build.py)."""
    if use_kernel(impl, guidance):
        return idepthmap_refiner_kernel(refiner, guidance, idepthmap)
    return idepthmap_refiner_plain(refiner, guidance, idepthmap)

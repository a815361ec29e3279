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
module (NCHW inside). Forward only.
"""

from __future__ import annotations

import ctypes

import torch

from .build import check_status, load_library, use_kernel
from .warp import grid_sample_plain
from ..warp import homography_grid

# Kernel launches since the last reset; only the kernel path counts.
launches = 0


def incremental_chain_plain(refiner, feats0: torch.Tensor, image_rest: torch.Tensor,
                            H_inc: torch.Tensor) -> torch.Tensor:
    """Python loop over the hypotheses, in the order of ``_incremental_scan``; the
    refiner runs on its plain version too, so this path launches no kernel."""
    h, w = feats0.shape[1], feats0.shape[2]
    feats = feats0
    volume = [feats0]
    for d in range(H_inc.shape[1]):
        grid = homography_grid(H_inc[:, d], h, w)
        warped, _ = grid_sample_plain(feats, grid, zero_invalid=True)
        image = image_rest[:, d].permute(0, 3, 1, 2)
        refined = refiner(image, warped.permute(0, 3, 1, 2), impl="plain")
        feats = refined.permute(0, 2, 3, 1).contiguous()
        volume.append(feats)
    return torch.stack(volume, dim=1)


def _library():
    lib = load_library("incremental_chain")
    fn = lib.mvs_incremental_chain_f32
    if fn.argtypes is None:
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


def incremental_chain_kernel(refiner, feats0: torch.Tensor, image_rest: torch.Tensor,
                             H_inc: torch.Tensor, cluster: int = 0) -> torch.Tensor:
    """Launch csrc/incremental_chain.cu: one thread-block cluster per sample runs all D-1
    steps. ``cluster`` sets the blocks a sample (0: the kernel chooses, see
    ``cluster_size``); a size the card refuses raises."""
    global launches
    tensors = (feats0, image_rest, H_inc) + tuple(refiner.parameters())
    if not all(t.is_cuda and t.device == feats0.device for t in tensors):
        raise ValueError("incremental_chain_kernel needs every tensor and weight "
                         "on one CUDA device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("incremental_chain_kernel takes float32 tensors and weights")
    N, h, w, C = feats0.shape
    Dm1 = H_inc.shape[1]
    if (C != 32 or refiner.conv0.weight.shape != (32, 35, 3, 3)
            or image_rest.shape != (N, Dm1, h, w, 3) or H_inc.shape != (N, Dm1, 3, 3)):
        raise ValueError(f"bad shapes: feats0 {tuple(feats0.shape)}, image_rest "
                         f"{tuple(image_rest.shape)}, H_inc {tuple(H_inc.shape)}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError("the CUDA incremental-chain kernel is forward only")
    res = refiner.res0
    vec = torch.stack([refiner.conv0.bias, refiner.bn0.weight, refiner.bn0.bias,
                       res.conv1.bias, res.bn1.weight, res.bn1.bias,
                       refiner.conv_final.bias]).contiguous()
    w0 = _taps(refiner.conv0.weight)
    wr = _taps(res.conv1.weight)
    wf = _taps(refiner.conv_final.weight)
    feats0 = feats0.contiguous()
    if feats0.data_ptr() % 16:  # the kernel reads it as float4
        feats0 = feats0.clone()
    image_rest = image_rest.contiguous()
    H_inc = H_inc.contiguous()
    out = torch.empty((N, Dm1 + 1, h, w, C), dtype=torch.float32, device=feats0.device)
    scratch = torch.empty((N, 3, h, w, C), dtype=torch.float32, device=feats0.device)
    stream = torch.cuda.current_stream(feats0.device).cuda_stream
    status = _library().mvs_incremental_chain_f32(
        feats0.data_ptr(), image_rest.data_ptr(), H_inc.data_ptr(), w0.data_ptr(),
        wr.data_ptr(), wf.data_ptr(), vec.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), N, Dm1, h, w, cluster, stream)
    check_status("mvs_incremental_chain_f32", status)
    launches += 1
    return out


def incremental_chain(refiner, feats0: torch.Tensor, image_rest: torch.Tensor,
                      H_inc: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """The chain: the kernel for CUDA tensors, the plain loop otherwise (see build.py)."""
    if use_kernel(impl, feats0):
        return incremental_chain_kernel(refiner, feats0, image_rest, H_inc)
    return incremental_chain_plain(refiner, feats0, image_rest, H_inc)

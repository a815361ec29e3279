"""The IDepthmapRefiner of a small level as one CUDA kernel (csrc/idepthmap_refiner.cu),
and its plain version.

Port of the TPU kernel ``multi_view_stereonet_tpu/ops/pallas/refiner_kernel.py``
(``idepthmap_refiner_fused``), whose semantics are ``models/refiners.py``
``idepthmap_refiner``. Layouts are the port's modules': guidance (N, Cg, h, w),
idepthmap (N, h, w), already fx-scaled by the caller -> ReLU(idepthmap + delta)
(N, h, w). The refiner is the port's ``IDepthmapRefiner`` module; its weights are
packed into the kernel's layout once and reused until a parameter changes
(``packed_weights``; after an in-place write through ``.data``, which no key sees,
call ``invalidate_packed_weights``). Forward only.
"""

from __future__ import annotations

import ctypes
import weakref

import torch

from .build import check_status, load_library, use_kernel
from .incremental_chain import _taps

# Kernel launches since the last reset; only the kernel path counts.
launches = 0

MAX_CIN0 = 36      # conv0 input channels the kernel's shared memory holds
NUM_RES = 6
NUM_GN = NUM_RES + 1
M_TILE = 16        # pixels a kernel m-tile, csrc/idepthmap_refiner.cu's MTILE
C = 32
WF_COLS = 8        # the final conv's one output channel, padded to an n8 tile

# refiner -> (parameters, their storages kept alive, each parameter's (data_ptr, version,
# dtype, device) and the dilations, (packed weights, dilations as a ctypes array))
_packs: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
# (device index, stream) -> the grid-barrier counter of launches on that stream
_barriers: dict = {}
_fn = None  # the kernel's ctypes entry, loaded on first use


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


def _kernel_function():
    """The ctypes entry of csrc/idepthmap_refiner.cu (built on first use)."""
    global _fn
    if _fn is None:
        fn = load_library("idepthmap_refiner").mvs_idepthmap_refiner_f32
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_void_p]
                       + [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def scratch_floats(n: int, h: int, w: int) -> int:
    """Floats of scratch a launch takes (the kernel checks it): h and T, double-buffered,
    then the f64 (sum, sum of squares) partials of 7 GroupNorms x 4 groups per m-tile."""
    m_tiles = n * -(-(h * w) // M_TILE)
    return 4 * n * h * w * C + NUM_GN * m_tiles * 4 * 4


def tf32_split(x: torch.Tensor):
    """(hi, lo) as the kernel splits an operand for 3xTF32: hi is x rounded to TF32 (10
    mantissa bits, half away from zero) on its integer bits, lo = x - hi exactly."""
    bits = x.contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return hi, x - hi


def pair_image(w: torch.Tensor) -> torch.Tensor:
    """(..., rows, cols) weights, cols 32 or 8 -> (..., rows, cols, 2) (hi, lo) pairs with
    the column of row r at col ^ s(r): s = 4 (r % 4) for 32 columns, 4 ((r // 2) % 2) for 8,
    as csrc/idepthmap_refiner.cu's wpair reads them (distinct banks for a half-warp)."""
    r = torch.arange(w.shape[-2], device=w.device)[:, None]
    s = (r & 3) << 2 if w.shape[-1] == C else ((r >> 1) & 1) << 2
    col = torch.arange(w.shape[-1], device=w.device)[None, :] ^ s
    hi, lo = tf32_split(w.gather(-1, col.expand(w.shape)))
    return torch.stack([hi, lo], dim=-1)


def _pack(refiner):
    """(packed weights, dilations) in the layout csrc/idepthmap_refiner.cu reads."""
    blocks = [getattr(refiner, f"res{i}") for i in range(NUM_RES)]
    params = tuple(refiner.parameters())
    if len({p.device for p in params}) != 1:
        raise ValueError("idepthmap_refiner_kernel needs every weight on one device")
    if any(p.dtype != torch.float32 for p in params):
        raise TypeError("idepthmap_refiner_kernel takes float32 tensors and weights")
    with torch.no_grad():
        w0 = _taps(refiner.conv0.weight)
        cin_pad = -(-w0.shape[1] // 4) * 4
        w0 = pair_image(torch.nn.functional.pad(w0, (0, 0, 0, cin_pad - w0.shape[1])))
        wr = pair_image(torch.stack([_taps(b.conv1.weight) for b in blocks]))
        wf = pair_image(torch.nn.functional.pad(_taps(refiner.conv_final.weight),
                                                (0, WF_COLS - 1)))
        rows = [refiner.conv0.bias, refiner.bn0.weight, refiner.bn0.bias]
        for b in blocks:
            rows += [b.conv1.bias, b.bn1.weight, b.bn1.bias]
        pack = torch.cat([w0.reshape(-1), wr.reshape(-1), wf.reshape(-1),
                          torch.stack(rows).reshape(-1), refiner.conv_final.bias])
    dilations = (ctypes.c_int * NUM_RES)(*(b.conv1.dilation[0] for b in blocks))
    return pack, dilations


def packed_weights(refiner):
    """The refiner's weights packed for the kernel, (pack, dilations).

    Packed on first use and reused while every parameter is the same tensor, on the
    same storage (``data_ptr``) at the same ``_version``, dtype and device, and the
    dilations are unchanged. So ``load_state_dict``, an in-place update of a parameter,
    ``p.data = ...``, ``vector_to_parameters``, a ``Module.to`` round trip and a move to
    another card all repack. The cache keeps the storages it packed from alive, so a
    new storage never takes an old one's address. A write through ``p.data`` in place
    (``p.data.mul_(...)``) keeps both the storage and the version, which no key can
    see: call ``invalidate_packed_weights`` after one. Parameters made under
    ``torch.inference_mode`` keep no version counter, so they are packed at every call.

    A CUDA graph captured over the kernel keeps the pack's address: after a repack,
    capture it again."""
    params = tuple(refiner.parameters())
    try:
        key = tuple((p.data_ptr(), p._version, p.dtype, p.device) for p in params) + tuple(
            getattr(refiner, f"res{i}").conv1.dilation[0] for i in range(NUM_RES))
    except RuntimeError:
        return _pack(refiner)
    cached = _packs.get(refiner)
    if (cached is not None and cached[2] == key
            and all(a is b for a, b in zip(cached[0], params))):
        return cached[3]
    packed = _pack(refiner)
    _packs[refiner] = (params, tuple(p.detach() for p in params), key, packed)
    return packed


def invalidate_packed_weights(refiner=None) -> None:
    """Drop the kernel's packed weights of ``refiner``, or of every refiner when it is
    None, so that the next launch packs them anew. A caller that writes weights in
    place through ``.data`` (``p.data.mul_(...)``, ``p.data.copy_(...)``) must call it:
    such a write changes neither the storage nor the version ``packed_weights`` keys on."""
    if refiner is None:
        _packs.clear()
    else:
        _packs.pop(refiner, None)


def _barrier(device: torch.device, stream: int) -> torch.Tensor:
    """The grid-barrier counter of launches on ``stream``: zeroed once, and left ready
    for the next launch by every launch. A launch captured in a CUDA graph keeps its
    capture stream's counter (one made during capture is zeroed by that graph at each
    replay), so graphs captured on one stream are replayed one at a time."""
    key = (device.index, stream)
    counter = _barriers.get(key)
    if counter is None:
        counter = _barriers[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return counter


def idepthmap_refiner_kernel(refiner, guidance: torch.Tensor,
                             idepthmap: torch.Tensor) -> torch.Tensor:
    """Launch csrc/idepthmap_refiner.cu: one cooperative grid runs the whole refiner.

    The weights come from ``packed_weights``: a caller that writes them in place
    through ``.data`` must call ``invalidate_packed_weights`` before the next launch."""
    global launches
    if not (guidance.is_cuda and idepthmap.device == guidance.device):
        raise ValueError("idepthmap_refiner_kernel needs every tensor and weight on one "
                         "CUDA device")
    if guidance.dtype != torch.float32 or idepthmap.dtype != torch.float32:
        raise TypeError("idepthmap_refiner_kernel takes float32 tensors and weights")
    if guidance.ndim != 4:
        raise ValueError(f"bad shapes: guidance {tuple(guidance.shape)}")
    N, Cg, h, w = guidance.shape
    if (idepthmap.shape != (N, h, w) or Cg + 1 > MAX_CIN0
            or refiner.conv0.weight.shape != (C, Cg + 1, 3, 3)
            or refiner.conv_final.weight.shape != (1, C, 3, 3)):
        raise ValueError(f"bad shapes: guidance {tuple(guidance.shape)}, idepthmap "
                         f"{tuple(idepthmap.shape)}, conv0 "
                         f"{tuple(refiner.conv0.weight.shape)}")
    if torch.is_grad_enabled() and (guidance.requires_grad or idepthmap.requires_grad or any(
            p.requires_grad for p in refiner.parameters())):
        raise NotImplementedError("the CUDA idepthmap-refiner kernel is forward only")
    pack, dilations = packed_weights(refiner)
    dev = guidance.device
    if pack.device != dev:
        raise ValueError("idepthmap_refiner_kernel needs every tensor and weight on one "
                         "CUDA device")
    guidance = guidance.contiguous()
    idepthmap = idepthmap.contiguous()
    fn = _kernel_function()
    out = torch.empty((N, h, w), dtype=torch.float32, device=dev)
    size = scratch_floats(N, h, w)
    scratch = torch.empty(size, dtype=torch.float32, device=dev)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    status = fn(guidance.data_ptr(), idepthmap.data_ptr(), pack.data_ptr(), out.data_ptr(),
                scratch.data_ptr(), size, _barrier(dev, stream).data_ptr(), N, Cg, h, w,
                dilations, stream)
    check_status("mvs_idepthmap_refiner_f32", status)
    launches += 1
    return out


def idepthmap_refiner(refiner, guidance: torch.Tensor, idepthmap: torch.Tensor,
                      impl: str = "auto") -> torch.Tensor:
    """ReLU(idepthmap + refiner delta): the kernel for CUDA tensors, the module's
    plain version otherwise (see build.py). After writing the refiner's weights in place
    through ``.data``, call ``invalidate_packed_weights``."""
    if use_kernel(impl, guidance):
        return idepthmap_refiner_kernel(refiner, guidance, idepthmap)
    return idepthmap_refiner_plain(refiner, guidance, idepthmap)

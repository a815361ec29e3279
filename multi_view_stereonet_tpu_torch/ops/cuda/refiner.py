"""The IDepthmapRefiner of a small level as one CUDA kernel (csrc/idepthmap_refiner.cu),
and its plain version.

Port of the TPU kernel ``multi_view_stereonet_tpu/ops/pallas/refiner_kernel.py``
(``idepthmap_refiner_fused``), whose semantics are ``models/refiners.py``
``idepthmap_refiner``. Layouts are the port's modules': guidance (N, Cg, h, w),
idepthmap (N, h, w), already fx-scaled by the caller -> ReLU(idepthmap + delta)
(N, h, w). The refiner is the port's ``IDepthmapRefiner`` module; its weights are
packed into the kernel's layout once and reused until a parameter changes
(``packed_weights``; after an in-place write through ``.data``, which no key sees,
call ``invalidate_packed_weights``). Under autograd the kernel runs in
``_IdepthmapRefiner``, which takes every parameter of the refiner as an input and whose
backward recomputes the module's plain version, as the JAX ``_fused_bwd``
(``refiner_kernel.py:244-252``) recomputes ``idepthmap_refiner_s2d`` (see
recompute.py). An optimizer step writes the weights in place, which bumps their
versions: the next launch repacks them once.
"""

from __future__ import annotations

import ctypes
import weakref

import torch

from .build import check_status, custom_op, load_library, tracing, use_kernel
from .recompute import bind_parameters, needs_autograd, plain_vjp
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
# dtype, device) and the dilations, (packed weights, dilations))
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
    return pack, tuple(b.conv1.dilation[0] for b in blocks)


def packed_floats(cin0: int) -> int:
    """Floats of a pack for a conv0 of ``cin0`` input channels (``_pack``'s layout): the
    three (hi, lo) weight images, the 21 bias and GroupNorm rows, the final bias."""
    cin_pad = -(-cin0 // 4) * 4
    return (2 * 9 * (cin_pad * C + NUM_RES * C * C + C * WF_COLS)
            + (3 + 3 * NUM_RES) * C + 1)


def _pack_key(params, refiner) -> tuple:
    """Each parameter's (data_ptr, version, dtype, device), then the dilations."""
    return tuple((p.data_ptr(), p._version, p.dtype, p.device) for p in params) + tuple(
        getattr(refiner, f"res{i}").conv1.dilation[0] for i in range(NUM_RES))


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
    capture it again. While ``torch.export`` traces, the parameters are fake tensors:
    the pack last made for this refiner is used as it is (the exported graph holds it as
    a constant) if the parameters it was made from are unchanged since, and the pack is
    traced from the parameters otherwise; nothing is cached then."""
    cached = _packs.get(refiner)
    if tracing():
        if cached is not None and cached[2] == _pack_key(cached[0], refiner):
            return cached[3]
        return _pack(refiner)
    params = tuple(refiner.parameters())
    try:
        key = _pack_key(params, refiner)
    except RuntimeError:
        return _pack(refiner)
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


def _output(guidance: torch.Tensor, idepthmap: torch.Tensor, pack: torch.Tensor,
            dilations: list[int]) -> torch.Tensor:
    """Check the inputs' devices, types and shapes; allocate the (N, h, w) output."""
    if idepthmap.device != guidance.device or pack.device != guidance.device:
        raise ValueError("idepthmap_refiner_kernel needs every tensor and weight on one "
                         "device")
    if any(t.dtype != torch.float32 for t in (guidance, idepthmap, pack)):
        raise TypeError("idepthmap_refiner_kernel takes float32 tensors and weights")
    if guidance.ndim != 4:
        raise ValueError(f"bad shapes: guidance {tuple(guidance.shape)}")
    N, Cg, h, w = guidance.shape
    if (idepthmap.shape != (N, h, w) or Cg + 1 > MAX_CIN0
            or pack.shape != (packed_floats(Cg + 1),) or len(dilations) != NUM_RES):
        raise ValueError(f"bad shapes: guidance {tuple(guidance.shape)}, idepthmap "
                         f"{tuple(idepthmap.shape)}, pack {tuple(pack.shape)}, dilations "
                         f"{list(dilations)}")
    return guidance.new_empty((N, h, w))


def _idepthmap_refiner_launch(guidance: torch.Tensor, idepthmap: torch.Tensor,
                              pack: torch.Tensor, dilations: list[int]) -> torch.Tensor:
    """Launch csrc/idepthmap_refiner.cu: one cooperative grid runs the whole refiner,
    its weights packed by ``_pack``."""
    global launches
    out = _output(guidance, idepthmap, pack, dilations)
    N, Cg, h, w = guidance.shape
    dev = guidance.device
    guidance = guidance.contiguous()
    idepthmap = idepthmap.contiguous()
    fn = _kernel_function()
    size = scratch_floats(N, h, w)
    scratch = torch.empty(size, dtype=torch.float32, device=dev)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    status = fn(guidance.data_ptr(), idepthmap.data_ptr(), pack.contiguous().data_ptr(),
                out.data_ptr(), scratch.data_ptr(), size, _barrier(dev, stream).data_ptr(),
                N, Cg, h, w, (ctypes.c_int * NUM_RES)(*dilations), stream)
    check_status("mvs_idepthmap_refiner_f32", status)
    launches += 1
    return out


_idepthmap_refiner_op = custom_op("idepthmap_refiner",
                                  "idepthmap_refiner")(_idepthmap_refiner_launch)
_idepthmap_refiner_op.register_fake(_output)


def _launch(refiner, guidance: torch.Tensor, idepthmap: torch.Tensor) -> torch.Tensor:
    """The kernel on CUDA tensors; while ``torch.export`` traces, through the custom op
    ``mvs_torch::idepthmap_refiner`` (see build.py ``custom_op``).

    The weights come from ``packed_weights``: a caller that writes them in place
    through ``.data`` must call ``invalidate_packed_weights`` before the next launch."""
    if not guidance.is_cuda:
        raise ValueError("idepthmap_refiner_kernel needs every tensor and weight on one "
                         "CUDA device")
    if (refiner.conv0.weight.shape != (C, guidance.shape[1] + 1, 3, 3)
            or refiner.conv_final.weight.shape != (1, C, 3, 3)):
        raise ValueError(f"bad shapes: guidance {tuple(guidance.shape)}, conv0 "
                         f"{tuple(refiner.conv0.weight.shape)}")
    pack, dilations = packed_weights(refiner)
    launch = _idepthmap_refiner_op if tracing() else _idepthmap_refiner_launch
    return launch(guidance, idepthmap, pack, list(dilations))


class _IdepthmapRefiner(torch.autograd.Function):
    """K3 under autograd: the kernel forward, given every parameter of the refiner as an
    input so that autograd routes their gradients; the backward recomputes the module's
    plain version with those weights."""

    @staticmethod
    def forward(ctx, refiner, names, guidance, idepthmap, *params):
        ctx.refiner, ctx.names = refiner, names
        ctx.save_for_backward(guidance, idepthmap, *params)
        return _launch(refiner, guidance, idepthmap)

    @staticmethod
    def backward(ctx, grad):
        def plain(guidance, idepthmap, *params):
            return idepthmap_refiner_plain(bind_parameters(ctx.refiner, ctx.names, params),
                                           guidance, idepthmap)
        return (None, None,
                *plain_vjp(plain, ctx.saved_tensors, ctx.needs_input_grad[2:], (grad,)))


def idepthmap_refiner_kernel(refiner, guidance: torch.Tensor,
                             idepthmap: torch.Tensor) -> torch.Tensor:
    """The kernel on CUDA tensors: launched directly, or through ``_IdepthmapRefiner``
    when autograd records."""
    if torch.is_grad_enabled():
        names, params = zip(*refiner.named_parameters())
        if needs_autograd(guidance, idepthmap, *params):
            return _IdepthmapRefiner.apply(refiner, names, guidance, idepthmap, *params)
    return _launch(refiner, guidance, idepthmap)


def idepthmap_refiner(refiner, guidance: torch.Tensor, idepthmap: torch.Tensor,
                      impl: str = "auto") -> torch.Tensor:
    """ReLU(idepthmap + refiner delta): the kernel for CUDA tensors, the module's
    plain version otherwise (see build.py). After writing the refiner's weights in place
    through ``.data``, call ``invalidate_packed_weights``."""
    if use_kernel(impl, guidance):
        return idepthmap_refiner_kernel(refiner, guidance, idepthmap)
    return idepthmap_refiner_plain(refiner, guidance, idepthmap)

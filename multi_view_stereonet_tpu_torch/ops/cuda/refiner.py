"""The IDepthmapRefiner of a small level as one CUDA kernel (csrc/idepthmap_refiner.cu),
and its plain version.

Port of the TPU kernel ``multi_view_stereonet_tpu/ops/pallas/refiner_kernel.py``
(``idepthmap_refiner_fused``), whose semantics are ``models/refiners.py``
``idepthmap_refiner``. Layouts are the port's modules': guidance (N, Cg, h, w),
idepthmap (N, h, w), already fx-scaled by the caller -> ReLU(idepthmap + delta)
(N, h, w). The convs run at the guidance's dtype, f32 or bf16; the idepthmap and
the output are f32. At bf16 the kernel follows the Pallas kernel's rounding
(``refiner_kernel.py:95-116,165-224``): each conv takes bf16 operands and
accumulates in f32, each GroupNorm + LeakyReLU rounds its f32 result to bf16 and
the residual is a rounded sum; the final conv's delta stays f32 and is added to
the f32 idepthmap. The refiner is the port's ``IDepthmapRefiner`` module; its
weights are packed into the kernel's layout once a storage dtype and reused until
a parameter changes
(``packed_weights``; after an in-place write through ``.data``, which no key sees,
call ``invalidate_packed_weights``). Under autograd the kernel runs in
``_IdepthmapRefiner``, which takes every parameter of the refiner as an input and whose
backward recomputes the module's plain version, as the JAX ``_fused_bwd``
(``refiner_kernel.py:244-252``) recomputes ``idepthmap_refiner_s2d`` (see
recompute.py). An optimizer step writes the weights in place, which bumps their
versions: the next launch repacks them once.

At f32 guidance the kernel has two variants: 3xTF32 (exact f32, the default) and 1xTF32
(``tf32``), which ``idepthmap_refiner`` takes inside a "tf32" precision scope
(``ops/precision.py``; the "refiners" stage at ``matmul_precision: high``). Each has its
own pack, (hi, lo) or (hi, 0) pairs, kept apart by the pack's key. Its plain version is
``idepthmap_refiner_tf32_plain``: the module with each conv operand rounded to TF32 as
the kernel rounds it, then exact.
"""

from __future__ import annotations

import ctypes
import weakref

import torch

from .. import precision
from .build import (
    barrier_counter, check_status, custom_op, launch_device, load_library, tracing,
    use_kernel)
from .recompute import bind_parameters, needs_autograd, plain_vjp
from .incremental_chain import _taps

# Kernel launches since the last reset; only the kernel path counts. tf32_launches
# counts those of the 1xTF32 variant among them.
launches = 0
tf32_launches = 0

MAX_CIN0 = 36      # conv0 input channels the kernel's shared memory holds
NUM_RES = 6
NUM_GN = NUM_RES + 1
M_TILE = 16        # pixels a kernel m-tile, csrc/idepthmap_refiner.cu's MTILE
C = 32
WF_COLS = 8        # the final conv's one output channel, padded to an n8 tile

# The guidance (storage) dtypes the kernel takes, and each one's entry in
# csrc/idepthmap_refiner.cu; TF32_ENTRY is the f32 guidance's 1xTF32 variant.
ENTRIES = {torch.float32: "mvs_idepthmap_refiner_f32",
           torch.bfloat16: "mvs_idepthmap_refiner_bf16"}
TF32_ENTRY = "mvs_idepthmap_refiner_tf32"

# refiner -> {(storage dtype, tf32): (parameters, their storages kept alive, the key
# (``_pack_key``), (packed weights, dilations))}
_packs: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_fns: dict = {}  # entry name -> the kernel's ctypes entry, loaded on first use


def fused_refiner_supported(h: int, w: int, n: int) -> bool:
    """The shape rule for sending a refiner through the kernel: the small levels.

    At 480x640 it selects levels 4 (30x40, n = B*V) and 3 (60x80, n = B), the
    levels the JAX gate selects (``refiner_kernel.py`` ``fused_refiner_supported``;
    its VMEM bound on the padded grid is a TPU limit and is not copied).
    """
    return h * w <= 60 * 80 and n <= 8


def idepthmap_refiner_plain(refiner, guidance: torch.Tensor,
                            idepthmap: torch.Tensor) -> torch.Tensor:
    """The module itself at the guidance's dtype, every piece on its plain PyTorch
    version."""
    return refiner(guidance, idepthmap, impl="plain", dtype=guidance.dtype)


def idepthmap_refiner_tf32_plain(refiner, guidance: torch.Tensor,
                                 idepthmap: torch.Tensor) -> torch.Tensor:
    """The plain version of the 1xTF32 kernel: ``idepthmap_refiner_plain`` with each conv
    operand (the staged input, the weights) rounded to TF32 as the kernel's ``split``
    rounds it, then computed in f32 (``precision.scope("tf32_round")``)."""
    with precision.scope("tf32_round"):
        return idepthmap_refiner_plain(refiner, guidance, idepthmap)


def _variant(dtype: torch.dtype, tf32: bool) -> tuple:
    """(storage dtype, 1xTF32?): bf16 guidance takes its bf16 variant at every
    precision, so ``tf32`` holds only at f32."""
    return dtype, bool(tf32) and dtype == torch.float32


def _entry(dtype: torch.dtype, tf32: bool) -> str:
    return TF32_ENTRY if _variant(dtype, tf32)[1] else ENTRIES[dtype]


def _kernel_function(dtype: torch.dtype, tf32: bool = False):
    """The ctypes entry of csrc/idepthmap_refiner.cu for ``dtype`` and ``tf32`` (built on
    first use)."""
    name = _entry(dtype, tf32)
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(load_library("idepthmap_refiner"), name)
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_void_p]
                       + [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def scratch_floats(n: int, h: int, w: int) -> int:
    """Floats of scratch a launch takes (the kernel checks it): h and T, double-buffered,
    then the f64 (sum, sum of squares) partials of 7 GroupNorms x 4 groups per m-tile."""
    m_tiles = n * -(-(h * w) // M_TILE)
    return 4 * n * h * w * C + NUM_GN * m_tiles * 4 * 4


def tf32_split(x: torch.Tensor):
    """(hi, lo) as the kernel splits an operand for 3xTF32: hi is x rounded to TF32 (10
    mantissa bits, half away from zero) on its integer bits, lo = x - hi exactly."""
    hi = precision.tf32_bits(x)
    return hi, x - hi


def pair_image(w: torch.Tensor, dtype: torch.dtype = torch.float32,
               tf32: bool = False) -> torch.Tensor:
    """(..., rows, cols) weights, cols 32 or 8 -> (..., rows, cols, 2) (hi, lo) pairs with
    the column of row r at col ^ s(r): s = 4 (r % 4) for 32 columns, 4 ((r // 2) % 2) for 8,
    as csrc/idepthmap_refiner.cu's wpair reads them (distinct banks for a half-warp). For
    the 1xTF32 kernel (f32, ``tf32``) the pair is (hi, 0); for the bf16 kernel (w rounded
    to bf16, 0)."""
    r = torch.arange(w.shape[-2], device=w.device)[:, None]
    s = (r & 3) << 2 if w.shape[-1] == C else ((r >> 1) & 1) << 2
    col = torch.arange(w.shape[-1], device=w.device)[None, :] ^ s
    w = w.gather(-1, col.expand(w.shape))
    if dtype == torch.float32:
        hi, lo = tf32_split(w)
        if tf32:
            lo = torch.zeros_like(hi)
    else:
        hi = w.to(dtype).float()
        lo = torch.zeros_like(hi)
    return torch.stack([hi, lo], dim=-1)


def _pack(refiner, dtype: torch.dtype = torch.float32, tf32: bool = False):
    """(packed weights, dilations) in the layout csrc/idepthmap_refiner.cu reads, for the
    kernel of storage ``dtype`` (f32: its 1xTF32 variant where ``tf32``)."""
    blocks = [getattr(refiner, f"res{i}") for i in range(NUM_RES)]
    params = tuple(refiner.parameters())
    if len({p.device for p in params}) != 1:
        raise ValueError("idepthmap_refiner_kernel needs every weight on one device")
    if any(p.dtype != torch.float32 for p in params):
        raise TypeError("idepthmap_refiner_kernel takes float32 tensors and weights")
    with torch.no_grad():
        w0 = _taps(refiner.conv0.weight)
        cin_pad = -(-w0.shape[1] // 4) * 4
        w0 = pair_image(torch.nn.functional.pad(w0, (0, 0, 0, cin_pad - w0.shape[1])), dtype,
                        tf32)
        wr = pair_image(torch.stack([_taps(b.conv1.weight) for b in blocks]), dtype, tf32)
        wf = pair_image(torch.nn.functional.pad(_taps(refiner.conv_final.weight),
                                                (0, WF_COLS - 1)), dtype, tf32)
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


def _pack_key(params, refiner, dtype: torch.dtype = torch.float32,
              tf32: bool = False) -> tuple:
    """The variant the pack is for (``_variant``: storage dtype and 1xTF32; the parameters
    stay f32 at every one), each parameter's (data_ptr, version, dtype, device), then the
    dilations."""
    return (_variant(dtype, tf32)
            + tuple((p.data_ptr(), p._version, p.dtype, p.device) for p in params)
            + tuple(getattr(refiner, f"res{i}").conv1.dilation[0] for i in range(NUM_RES)))


def packed_weights(refiner, dtype: torch.dtype = torch.float32, tf32: bool = False):
    """The refiner's weights packed for the kernel of storage ``dtype`` (f32: its 1xTF32
    variant where ``tf32``), (pack, dilations); one pack is kept a variant, so a 3xTF32
    pack is never served to the 1xTF32 kernel nor the reverse.

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
    variant = _variant(dtype, tf32)
    cached = _packs.get(refiner, {}).get(variant)
    if tracing():
        if cached is not None and cached[2] == _pack_key(cached[0], refiner, *variant):
            return cached[3]
        return _pack(refiner, *variant)
    params = tuple(refiner.parameters())
    try:
        key = _pack_key(params, refiner, *variant)
    except RuntimeError:
        return _pack(refiner, *variant)
    if (cached is not None and cached[2] == key
            and all(a is b for a, b in zip(cached[0], params))):
        return cached[3]
    packed = _pack(refiner, *variant)
    _packs.setdefault(refiner, {})[variant] = (params, tuple(p.detach() for p in params),
                                               key, packed)
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


def _output(guidance: torch.Tensor, idepthmap: torch.Tensor, pack: torch.Tensor,
            dilations: list[int], tf32: bool = False) -> torch.Tensor:
    """Check the inputs' devices, types and shapes; allocate the (N, h, w) f32 output."""
    if idepthmap.device != guidance.device or pack.device != guidance.device:
        raise ValueError("idepthmap_refiner_kernel needs every tensor and weight on one "
                         "device")
    if (guidance.dtype not in ENTRIES or idepthmap.dtype != torch.float32
            or pack.dtype != torch.float32):
        raise TypeError("idepthmap_refiner_kernel takes float32 or bfloat16 guidance and "
                        "float32 idepthmap and weights")
    if guidance.ndim != 4:
        raise ValueError(f"bad shapes: guidance {tuple(guidance.shape)}")
    N, Cg, h, w = guidance.shape
    if (idepthmap.shape != (N, h, w) or Cg + 1 > MAX_CIN0
            or pack.shape != (packed_floats(Cg + 1),) or len(dilations) != NUM_RES):
        raise ValueError(f"bad shapes: guidance {tuple(guidance.shape)}, idepthmap "
                         f"{tuple(idepthmap.shape)}, pack {tuple(pack.shape)}, dilations "
                         f"{list(dilations)}")
    return idepthmap.new_empty((N, h, w))


def _idepthmap_refiner_launch(guidance: torch.Tensor, idepthmap: torch.Tensor,
                              pack: torch.Tensor, dilations: list[int],
                              tf32: bool = False) -> torch.Tensor:
    """Launch csrc/idepthmap_refiner.cu: one cooperative grid runs the whole refiner at
    the guidance's dtype (f32: 1xTF32 where ``tf32``, else 3xTF32), its weights packed by
    ``_pack`` for that variant."""
    global launches, tf32_launches
    out = _output(guidance, idepthmap, pack, dilations)
    N, Cg, h, w = guidance.shape
    dev = guidance.device
    guidance = guidance.contiguous()
    idepthmap = idepthmap.contiguous()
    fn = _kernel_function(guidance.dtype, tf32)
    size = scratch_floats(N, h, w)
    scratch = torch.empty(size, dtype=torch.float32, device=dev)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    with launch_device(dev):
        status = fn(guidance.data_ptr(), idepthmap.data_ptr(), pack.contiguous().data_ptr(),
                    out.data_ptr(), scratch.data_ptr(), size,
                    barrier_counter(dev, stream).data_ptr(), N, Cg, h, w,
                    (ctypes.c_int * NUM_RES)(*dilations), stream)
    entry = _entry(guidance.dtype, tf32)
    check_status(entry, status)
    launches += 1
    tf32_launches += entry == TF32_ENTRY
    return out


_idepthmap_refiner_op = custom_op("idepthmap_refiner",
                                  "idepthmap_refiner")(_idepthmap_refiner_launch)
_idepthmap_refiner_op.register_fake(_output)


def _launch(refiner, guidance: torch.Tensor, idepthmap: torch.Tensor,
            tf32: bool) -> torch.Tensor:
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
    pack, dilations = packed_weights(refiner, guidance.dtype, tf32)
    launch = _idepthmap_refiner_op if tracing() else _idepthmap_refiner_launch
    return launch(guidance, idepthmap, pack, list(dilations), _variant(guidance.dtype, tf32)[1])


class _IdepthmapRefiner(torch.autograd.Function):
    """K3 under autograd: the kernel forward, given every parameter of the refiner as an
    input so that autograd routes their gradients; the backward recomputes the module's
    plain version with those weights, its convs at the forward's precision (under cuDNN's
    TF32 after the 1xTF32 variant, exact otherwise)."""

    @staticmethod
    def forward(ctx, refiner, names, tf32, guidance, idepthmap, *params):
        ctx.refiner, ctx.names, ctx.tf32 = refiner, names, tf32
        ctx.save_for_backward(guidance, idepthmap, *params)
        return _launch(refiner, guidance, idepthmap, tf32)

    @staticmethod
    def backward(ctx, grad):
        def plain(guidance, idepthmap, *params):
            return idepthmap_refiner_plain(bind_parameters(ctx.refiner, ctx.names, params),
                                           guidance, idepthmap)
        with precision.scope("tf32" if ctx.tf32 else "ieee"):
            return (None, None, None,
                    *plain_vjp(plain, ctx.saved_tensors, ctx.needs_input_grad[3:], (grad,)))


def idepthmap_refiner_kernel(refiner, guidance: torch.Tensor, idepthmap: torch.Tensor,
                             tf32: bool = False) -> torch.Tensor:
    """The kernel on CUDA tensors (``tf32``: the 1xTF32 variant at f32 guidance):
    launched directly, or through ``_IdepthmapRefiner`` when autograd records."""
    if torch.is_grad_enabled():
        names, params = zip(*refiner.named_parameters())
        if needs_autograd(guidance, idepthmap, *params):
            return _IdepthmapRefiner.apply(refiner, names, tf32, guidance, idepthmap, *params)
    return _launch(refiner, guidance, idepthmap, tf32)


def idepthmap_refiner(refiner, guidance: torch.Tensor, idepthmap: torch.Tensor,
                      impl: str = "auto") -> torch.Tensor:
    """ReLU(idepthmap + refiner delta), the convs at the guidance's dtype and at the open
    precision scope's mode: the kernel for CUDA tensors (1xTF32 in a "tf32" scope), the
    module's plain version otherwise (see build.py and ops/precision.py). After writing
    the refiner's weights in place through ``.data``, call ``invalidate_packed_weights``."""
    if use_kernel(impl, guidance):
        return idepthmap_refiner_kernel(refiner, guidance, idepthmap,
                                        tf32=precision.current() == "tf32")
    return idepthmap_refiner_plain(refiner, guidance, idepthmap)

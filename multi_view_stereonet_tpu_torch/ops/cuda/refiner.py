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
``_IdepthmapRefiner``, which takes every parameter of the refiner as an input; its
forward also keeps each GroupNorm layer's raw conv output T_l and its h_l, and each
GroupNorm's statistics, and its backward launches the backward kernel
(``idepthmap_refiner_backward``, counted in ``backward_launches``) on those: the VJP of
the refiner that the JAX ``_fused_bwd`` (``refiner_kernel.py:244-252``) takes by
recomputing ``idepthmap_refiner_s2d``. Its plain version in closed form is
``idepthmap_refiner_backward_plain``, fed by the forward kernel's plain version
(``idepthmap_refiner_saved_plain``) or by what the kernel kept. The kept maps cost 14 x
N x h x w x 32 f32 (69 MB at (8, 35, 60, 80)). An optimizer step writes the weights in
place, which bumps their versions: the next launch repacks them once.

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
import torch.nn.functional as F

from .. import precision
from .build import (
    barrier_counter, check_status, custom_op, launch_device, load_library, needs_autograd,
    tracing, use_kernel)
from .closed_form import (
    _conv_grads, _gn_backward, _gn_forward, _GradRound, _group_stats, _leaky, _nchw,
    _operand_round, _round_to)
from .incremental_chain import _taps, _untaps

# Kernel launches since the last reset; only the kernel path counts. tf32_launches
# counts those of the 1xTF32 variant among them; backward_launches the backward's (two a
# backward: the sequential part's and the weight-gradient pass's), wgrad_launches the
# pass's among them.
launches = 0
tf32_launches = 0
backward_launches = 0
wgrad_launches = 0

MAX_CIN0 = 36      # conv0 input channels the kernel's shared memory holds
# The weight-gradient pass's slots (csrc/wgrad.cuh): floats a block's sums take, and its
# blocks an SM (csrc/idepthmap_refiner.cu WGRAD_MIN_BLOCKS).
WGRAD_SLOT_FLOATS = 9 * 48 * 32 + 32
WGRAD_BLOCKS_PER_SM = 1
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
# The backward's two kernels' entries, named as the forward's with "_bwd" (the sequential
# part) and "_wgrad" (the weight-gradient pass).
_PTR, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGS = {"forward": [_PTR] * 5 + [_LL] + [_PTR] * 4 + [_INT] * 4
                    + [ctypes.POINTER(ctypes.c_int), _PTR],
         "bwd": [_PTR] * 13 + [_LL, _PTR, _PTR, _LL, _PTR] + [_INT] * 4
                + [ctypes.POINTER(ctypes.c_int), _PTR],
         "wgrad": [_PTR] * 6 + [_INT, _PTR, _PTR, _LL, _PTR] + [_INT] * 4
                  + [ctypes.POINTER(ctypes.c_int), _PTR]}

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


def _dilations(refiner) -> tuple:
    return tuple(getattr(refiner, f"res{i}").conv1.dilation[0] for i in range(NUM_RES))


def idepthmap_refiner_saved_plain(refiner, guidance: torch.Tensor, idepthmap: torch.Tensor,
                                  tf32: bool = False) -> tuple:
    """The forward kernel's plain version under autograd: (out, raw, stats) at its rounding
    points, where out is the (N, h, w) f32 output, raw (7, N, h, w, 32) f32 each GroupNorm
    layer's conv + bias (conv0's, then the resblocks') and stats (7, N, 2, 4) f32 each of
    those GroupNorms' (mean, rstd) per group: the tensors the backward reads. Its convs at
    the kernel's operand rounding (``tf32``: the 1xTF32 variant's)."""
    with torch.no_grad():
        return saved_forward([p.detach().float() for p in refiner.parameters()], guidance,
                             idepthmap, _dilations(refiner), tf32)


def saved_forward(weights, guidance: torch.Tensor, idepthmap: torch.Tensor, dilations,
                  tf32: bool = False) -> tuple:
    """``idepthmap_refiner_saved_plain`` on f32 ``weights`` in the refiner's
    ``parameters()`` order, differentiable in them and in the inputs: plain autograd through
    the same forward that the closed-form backward reads, each conv's output gradient
    rounded as the closed form rounds it (``_GradRound``), so that autograd's conv backward
    takes the closed form's operands. As the kernel rounds at bf16 guidance: the staged
    input [guidance, idepth rounded to bf16], each conv on bf16 operands with its bias
    added in f32, h_0 = bf16(LeakyReLU(GN_0)), h_l = bf16(h_{l-1} +
    bf16(LeakyReLU(GN_l))), the final conv's delta f32."""
    dtype = guidance.dtype
    rnd = _operand_round(dtype, tf32)
    x = torch.cat([guidance.float().permute(0, 2, 3, 1),
                   _round_to(dtype, idepthmap.float())[..., None]], -1)
    raws, stats = [], []
    with precision.scope("ieee"):
        for k in range(NUM_GN):
            w, b, gamma, beta = weights[4 * k:4 * k + 4]
            d = 1 if k == 0 else dilations[k - 1]
            t = _GradRound.apply(F.conv2d(_nchw(rnd(x)), rnd(w), None, padding=d,
                                          dilation=d), rnd).permute(0, 2, 3, 1) + b
            st = _group_stats(t)
            branch = _leaky(_gn_forward(t, st, gamma, beta)[1], dtype)
            x = branch if k == 0 else _round_to(dtype, x + branch)
            raws.append(t)
            stats.append(st)
        wf, bf = weights[-2:]
        delta = _GradRound.apply(F.conv2d(_nchw(rnd(x)), rnd(wf), None, padding=1), rnd)[:, 0]
        out = torch.relu(idepthmap.float() + (delta + bf))
    return out, torch.stack(raws), torch.stack(stats)


def _hidden(raw: torch.Tensor, stats: torch.Tensor, weights, dtype: torch.dtype) -> list:
    """h_0 .. h_6 rebuilt from each GroupNorm layer's raw conv output and statistics in the
    forward's order and roundings."""
    hs = []
    for k in range(NUM_GN):
        branch = _leaky(_gn_forward(raw[k], stats[k], *weights[4 * k + 2:4 * k + 4])[1], dtype)
        hs.append(branch if k == 0 else _round_to(dtype, hs[-1] + branch))
    return hs


def _conv0_input(guidance: torch.Tensor, idepthmap: torch.Tensor) -> torch.Tensor:
    """conv0's input [guidance, idepthmap rounded to the guidance's dtype], NHWC f32."""
    return torch.cat([guidance.float().permute(0, 2, 3, 1),
                      _round_to(guidance.dtype, idepthmap.float())[..., None]], -1)


def idepthmap_refiner_sequential_plain(refiner, guidance: torch.Tensor,
                                       idepthmap: torch.Tensor, out: torch.Tensor,
                                       raw: torch.Tensor, stats: torch.Tensor,
                                       grad: torch.Tensor, tf32: bool = False) -> tuple:
    """The backward's sequential part's plain version (``idepthmap_refiner_sequential``):
    (d guidance at the guidance's dtype, d idepthmap, gmaps, gout, gn) from the forward's
    saved tensors (``out``, ``raw``, ``stats``, as ``idepthmap_refiner_saved_plain`` gives
    them) and the output's gradient ``grad``: the reverse loop of the kernel, the final
    conv's input gradient through ReLU, then each GroupNorm layer's backward (LeakyReLU,
    GroupNorm, the conv's input gradient; the residual's gradient added), conv0's last.
    gmaps (7, N, h, w, 32) f32 is each GroupNorm layer's conv output gradient dT_l, gout
    (N, h, w) f32 the final conv's, gn (7, 2, 32) f32 each GroupNorm's (d gamma, d beta):
    what the weight-gradient pass reads. The convs' operands are rounded as the kernel's
    are (``_operand_round``); the elementwise terms are f32, the map sums f64."""
    dtype = guidance.dtype
    rnd = _operand_round(dtype, tf32)
    weights = [p.detach().float() for p in refiner.parameters()]
    dilations = _dilations(refiner)
    with torch.no_grad(), precision.scope("ieee"):
        hs = _hidden(raw, stats, weights, dtype)
        gout = grad.float() * (out > 0)
        dh, _ = _conv_grads(hs[-1], weights[-2], gout[..., None], rnd, which=(True, False))
        gmaps, gn = [None] * NUM_GN, [None] * NUM_GN
        for k in range(NUM_GN - 1, -1, -1):
            w, _, gamma, beta = weights[4 * k:4 * k + 4]
            xhat, z = _gn_forward(raw[k], stats[k], gamma, beta)
            gmaps[k], dgamma, dbeta = _gn_backward(dh, z, xhat, stats[k], gamma, dtype)
            gn[k] = torch.stack([dgamma, dbeta])
            d = 1 if k == 0 else dilations[k - 1]
            gx, _ = _conv_grads(_conv0_input(guidance, idepthmap) if k == 0 else hs[k - 1],
                                w, gmaps[k], rnd, d, which=(True, False))
            if k > 0:
                dh = dh + gx
        cg = guidance.shape[1]
    return (gx[..., :cg].permute(0, 3, 1, 2).to(dtype), gout + gx[..., cg],
            torch.stack(gmaps), gout, torch.stack(gn))


def idepthmap_refiner_wgrad_plain(refiner, guidance: torch.Tensor, idepthmap: torch.Tensor,
                                  raw: torch.Tensor, stats: torch.Tensor, gmaps: torch.Tensor,
                                  gout: torch.Tensor, gn: torch.Tensor,
                                  tf32: bool = False) -> tuple:
    """The backward's weight-gradient pass's plain version (``idepthmap_refiner_wgrad``):
    (d parameter for each of the refiner's ``named_parameters``) from the kept maps, as
    ``idepthmap_refiner_sequential_plain`` gives them: each conv's weight gradient, its
    input X (h_{l-1} rebuilt from ``raw`` and ``stats``; conv0's [guidance, idepthmap]) and
    its output gradient G (``gmaps``' dT_l; the final conv's ``gout``) rounded as the
    kernel's convs round them; its bias gradient sum G in f32; each GroupNorm's (d gamma,
    d beta) from ``gn``."""
    dtype = guidance.dtype
    rnd = _operand_round(dtype, tf32)
    weights = [p.detach().float() for p in refiner.parameters()]
    dilations = _dilations(refiner)
    with torch.no_grad(), precision.scope("ieee"):
        hs = _hidden(raw, stats, weights, dtype)
        dparams = [None] * len(weights)
        _, dparams[-2] = _conv_grads(hs[-1], weights[-2], gout[..., None], rnd,
                                     which=(False, True))
        dparams[-1] = gout.sum().reshape(1)
        for k in range(NUM_GN):
            d = 1 if k == 0 else dilations[k - 1]
            _, dw = _conv_grads(_conv0_input(guidance, idepthmap) if k == 0 else hs[k - 1],
                                weights[4 * k], gmaps[k], rnd, d, which=(False, True))
            dparams[4 * k:4 * k + 4] = dw, gmaps[k].sum((0, 1, 2)), gn[k, 0], gn[k, 1]
    return tuple(dparams)


def idepthmap_refiner_backward_plain(refiner, guidance: torch.Tensor, idepthmap: torch.Tensor,
                                     out: torch.Tensor, raw: torch.Tensor, stats: torch.Tensor,
                                     grad: torch.Tensor, needs=(True, True, True),
                                     tf32: bool = False) -> tuple:
    """The backward's plain version: the gradients (d guidance, d idepthmap, (d parameter
    for each of the refiner's ``named_parameters``)) of the refiner given its output's
    gradient ``grad``, in closed form over the forward's saved tensors (``out``, ``raw``,
    ``stats``, as ``idepthmap_refiner_saved_plain`` gives them): the plain versions of its
    two launches, ``idepthmap_refiner_sequential_plain`` then
    ``idepthmap_refiner_wgrad_plain`` on the maps it keeps. None for what ``needs``
    (guidance, idepthmap, the parameters) leaves out; d guidance at the guidance's dtype,
    the rest f32."""
    dguid, didepth, gmaps, gout, gn = idepthmap_refiner_sequential_plain(
        refiner, guidance, idepthmap, out, raw, stats, grad, tf32)
    dparams = (idepthmap_refiner_wgrad_plain(refiner, guidance, idepthmap, raw, stats, gmaps,
                                             gout, gn, tf32) if needs[2] else None)
    return dguid if needs[0] else None, didepth if needs[1] else None, dparams


def _variant(dtype: torch.dtype, tf32: bool) -> tuple:
    """(storage dtype, 1xTF32?): bf16 guidance takes its bf16 variant at every
    precision, so ``tf32`` holds only at f32."""
    return dtype, bool(tf32) and dtype == torch.float32


def _entry(dtype: torch.dtype, tf32: bool) -> str:
    return TF32_ENTRY if _variant(dtype, tf32)[1] else ENTRIES[dtype]


def _kernel_function(dtype: torch.dtype, tf32: bool = False, part: str = "forward"):
    """The ctypes entry of csrc/idepthmap_refiner.cu for ``dtype`` and ``tf32``: the
    forward's, or the backward's ``part`` ("bwd": the sequential part; "wgrad": the
    weight-gradient pass) (built on first use)."""
    name = _entry(dtype, tf32)
    if part != "forward":
        name = name.replace("refiner_", f"refiner_{part}_")
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(load_library("idepthmap_refiner"), name)
        fn.argtypes = _ARGS[part]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def scratch_floats(n: int, h: int, w: int, maps: int = 4) -> int:
    """Floats of scratch a launch takes (the kernel checks it): ``maps`` (N, h, w, 32)
    maps (the forward's h and T double-buffered: 4; kept for the backward: 0; the
    backward's dh double-buffered: 2), then the f64 (sum, sum of squares) partials of 7
    GroupNorms x 4 groups per m-tile."""
    m_tiles = n * -(-(h * w) // M_TILE)
    return maps * n * h * w * C + NUM_GN * m_tiles * 4 * 4


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


def _forward_launch(guidance: torch.Tensor, idepthmap: torch.Tensor, pack: torch.Tensor,
                    dilations: list[int], tf32: bool = False, keep: bool = False):
    """Launch csrc/idepthmap_refiner.cu: one cooperative grid runs the whole refiner at
    the guidance's dtype (f32: 1xTF32 where ``tf32``, else 3xTF32), its weights packed by
    ``_pack`` for that variant. Returns the (N, h, w) output; with ``keep`` (under
    autograd) (out, raw, stats, hs), the kernel also writing what the backward reads: each
    GroupNorm layer's raw conv output T_l (raw) and its h_l (hs), (7, N, h, w, 32), and
    each GroupNorm's mean and rstd (stats, (7, N, 2, 4)), f32."""
    global launches, tf32_launches
    out = _output(guidance, idepthmap, pack, dilations)
    N, Cg, h, w = guidance.shape
    dev = guidance.device
    guidance = guidance.contiguous()
    idepthmap = idepthmap.contiguous()
    fn = _kernel_function(guidance.dtype, tf32)
    f32 = dict(dtype=torch.float32, device=dev)
    size = scratch_floats(N, h, w, 0 if keep else 4)
    scratch = torch.empty(size, **f32)
    raw = torch.empty((NUM_GN, N, h, w, C), **f32) if keep else None
    hs = torch.empty((NUM_GN, N, h, w, C), **f32) if keep else None
    stats = torch.empty((NUM_GN, N, 2, 4), **f32) if keep else None
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    with launch_device(dev):
        status = fn(guidance.data_ptr(), idepthmap.data_ptr(), pack.contiguous().data_ptr(),
                    out.data_ptr(), scratch.data_ptr(), size,
                    *(t.data_ptr() if keep else 0 for t in (raw, hs, stats)),
                    barrier_counter(dev, stream).data_ptr(), N, Cg, h, w,
                    (ctypes.c_int * NUM_RES)(*dilations), stream)
    entry = _entry(guidance.dtype, tf32)
    check_status(entry, status)
    launches += 1
    tf32_launches += entry == TF32_ENTRY
    return (out, raw, stats, hs) if keep else out


def _idepthmap_refiner_launch(guidance: torch.Tensor, idepthmap: torch.Tensor,
                              pack: torch.Tensor, dilations: list[int],
                              tf32: bool = False) -> torch.Tensor:
    """The forward kernel's output alone (``_forward_launch`` without ``keep``)."""
    return _forward_launch(guidance, idepthmap, pack, dilations, tf32)


_idepthmap_refiner_op = custom_op("idepthmap_refiner",
                                  "idepthmap_refiner")(_idepthmap_refiner_launch)
_idepthmap_refiner_op.register_fake(_output)


def _launch(refiner, guidance: torch.Tensor, idepthmap: torch.Tensor, tf32: bool,
            keep: bool = False):
    """The kernel on CUDA tensors; while ``torch.export`` traces, through the custom op
    ``mvs_torch::idepthmap_refiner`` (see build.py ``custom_op``). With ``keep`` (under
    autograd) it returns (out, saved): saved is what ``_launch_backward`` takes, the
    kept (raw, stats, hs) and the weight pack the forward ran on.

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
    tf32 = _variant(guidance.dtype, tf32)[1]
    if keep:
        out, raw, stats, hs = _forward_launch(guidance, idepthmap, pack, list(dilations),
                                              tf32, keep=True)
        return out, (raw, stats, hs, pack)
    launch = _idepthmap_refiner_op if tracing() else _idepthmap_refiner_launch
    return launch(guidance, idepthmap, pack, list(dilations), tf32)


def grad_floats(cin0: int) -> int:
    """Floats of the backward kernel's parameter gradients for a conv0 of ``cin0`` input
    channels: conv0's taps (9, cin_pad, 32), the resblocks' (6, 9, 32, 32), the final
    conv's (9, 32), then the 21 bias and GroupNorm rows and the final bias."""
    cin_pad = -(-cin0 // 4) * 4
    return 9 * (cin_pad * C + NUM_RES * C * C + C) + (3 + 3 * NUM_RES) * C + 1


def idepthmap_refiner_sequential(guidance: torch.Tensor, idepthmap: torch.Tensor,
                                 pack: torch.Tensor, dilations, out: torch.Tensor,
                                 raw: torch.Tensor, stats: torch.Tensor, hs: torch.Tensor,
                                 grad: torch.Tensor, need_guidance: bool = True,
                                 tf32: bool = False) -> tuple:
    """The backward's sequential part (csrc/idepthmap_refiner.cu ``refiner_bwd_kernel``) on
    CUDA tensors: from the forward's inputs, the pack it ran on, its output ``out``, what
    it kept (``raw``, ``stats``, ``hs``) and the output's gradient ``grad``, (d guidance
    f32, or None without ``need_guidance``; d idepthmap f32; gmaps (7, N, h, w, 32) f32,
    each GroupNorm layer's dT_l; gout (N, h, w) f32; gnpart (blocks, 7, 2, 32) f64, each
    block's (d gamma, d beta)): the forward's cooperative grid over the layers in reverse.
    The contract of ``idepthmap_refiner_sequential_plain``, its gn the sum of gnpart over
    the blocks."""
    global backward_launches
    dtype = guidance.dtype
    tensors = (guidance, idepthmap, pack, out, raw, stats, hs, grad)
    if not all(t.is_cuda and t.device == out.device for t in tensors):
        raise ValueError("idepthmap_refiner_backward needs every tensor on one CUDA device")
    if dtype not in ENTRIES or any(t.dtype != torch.float32 for t in tensors[1:]):
        raise TypeError("idepthmap_refiner_backward takes float32 or bfloat16 guidance and "
                        "everything else float32")
    N, Cg, h, w = guidance.shape
    if (idepthmap.shape != (N, h, w) or out.shape != (N, h, w) or grad.shape != (N, h, w)
            or raw.shape != (NUM_GN, N, h, w, C) or hs.shape != raw.shape
            or stats.shape != (NUM_GN, N, 2, 4) or pack.shape != (packed_floats(Cg + 1),)
            or len(dilations) != NUM_RES):
        raise ValueError(f"bad shapes: guidance {tuple(guidance.shape)}, out "
                         f"{tuple(out.shape)}, grad {tuple(grad.shape)}, raw "
                         f"{tuple(raw.shape)}, stats {tuple(stats.shape)}")
    dev = out.device
    f32 = dict(dtype=torch.float32, device=dev)
    dguid = torch.empty((N, Cg, h, w), **f32) if need_guidance else None
    didepth = torch.empty((N, h, w), **f32)
    gmaps = torch.empty((NUM_GN, N, h, w, C), **f32)
    gout = torch.empty((N, h, w), **f32)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gnpart = torch.empty((sms, NUM_GN, 2, C), dtype=torch.float64, device=dev)
    size = scratch_floats(N, h, w, 2)
    scratch = torch.empty(size, **f32)
    blocks = ctypes.c_int(0)
    args = [t.contiguous() for t in (guidance, idepthmap, pack, out, raw, hs, stats, grad)]
    entry = _entry(dtype, tf32).replace("refiner_", "refiner_bwd_")
    fn = _kernel_function(dtype, tf32, "bwd")
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    with launch_device(dev):
        status = fn(*(t.data_ptr() for t in args),
                    0 if dguid is None else dguid.data_ptr(), didepth.data_ptr(),
                    gmaps.data_ptr(), gout.data_ptr(), gnpart.data_ptr(), gnpart.numel(),
                    ctypes.byref(blocks), scratch.data_ptr(), size,
                    barrier_counter(dev, stream).data_ptr(), N, Cg, h, w,
                    (ctypes.c_int * NUM_RES)(*dilations), stream)
    check_status(entry, status)
    backward_launches += 1
    return dguid, didepth, gmaps, gout, gnpart[:blocks.value]


def idepthmap_refiner_wgrad(guidance: torch.Tensor, idepthmap: torch.Tensor, dilations,
                            hs: torch.Tensor, gmaps: torch.Tensor, gout: torch.Tensor,
                            gnpart: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    """The backward's weight-gradient pass (csrc/idepthmap_refiner.cu
    ``refiner_wgrad_kernel``, csrc/wgrad.cuh) on CUDA tensors: from the forward's guidance
    and idepthmap, its kept ``hs`` and what the sequential part kept (``gmaps``, ``gout``,
    ``gnpart``), the parameter gradients, f32, in ``grad_floats``' layout: one cooperative
    launch over every SM, each block a share of one conv's pixels, the blocks' sums added
    in block order. The contract of ``idepthmap_refiner_wgrad_plain``."""
    global backward_launches, wgrad_launches
    dtype = guidance.dtype
    N, Cg, h, w = guidance.shape
    tensors = (guidance, idepthmap, hs, gmaps, gout, gnpart)
    if not all(t.is_cuda and t.device == guidance.device for t in tensors):
        raise ValueError("idepthmap_refiner_wgrad needs every tensor on one CUDA device")
    if (dtype not in ENTRIES or any(t.dtype != torch.float32 for t in tensors[1:5])
            or gnpart.dtype != torch.float64):
        raise TypeError("idepthmap_refiner_wgrad takes float32 or bfloat16 guidance, float64 "
                        "gnpart and everything else float32")
    if (idepthmap.shape != (N, h, w) or hs.shape != (NUM_GN, N, h, w, C)
            or gmaps.shape != hs.shape or gout.shape != (N, h, w)
            or gnpart.shape[1:] != (NUM_GN, 2, C) or len(dilations) != NUM_RES):
        raise ValueError(f"bad shapes: guidance {tuple(guidance.shape)}, gmaps "
                         f"{tuple(gmaps.shape)}, gout {tuple(gout.shape)}, gnpart "
                         f"{tuple(gnpart.shape)}")
    dev = guidance.device
    dparams = torch.empty(grad_floats(Cg + 1), dtype=torch.float32, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    partial = torch.empty(sms * WGRAD_BLOCKS_PER_SM * WGRAD_SLOT_FLOATS, dtype=torch.float32,
                          device=dev)
    args = [t.contiguous() for t in (guidance, idepthmap, hs, gmaps, gout, gnpart)]
    entry = _entry(dtype, tf32).replace("refiner_", "refiner_wgrad_")
    fn = _kernel_function(dtype, tf32, "wgrad")
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    with launch_device(dev):
        status = fn(*(t.data_ptr() for t in args), gnpart.shape[0], dparams.data_ptr(),
                    partial.data_ptr(), partial.numel(),
                    barrier_counter(dev, stream).data_ptr(), N, Cg, h, w,
                    (ctypes.c_int * NUM_RES)(*dilations), stream)
    check_status(entry, status)
    backward_launches += 1
    wgrad_launches += 1
    return dparams


def idepthmap_refiner_backward(guidance: torch.Tensor, idepthmap: torch.Tensor,
                               pack: torch.Tensor, dilations, out: torch.Tensor,
                               raw: torch.Tensor, stats: torch.Tensor, hs: torch.Tensor,
                               grad: torch.Tensor, need_guidance: bool = True,
                               tf32: bool = False) -> tuple:
    """The backward on CUDA tensors: from the forward's inputs, the pack it ran on, its
    output ``out``, what it kept (``raw``, ``stats``, ``hs``) and the output's gradient
    ``grad``, the gradients (d guidance f32, or None without ``need_guidance``; d
    idepthmap f32; the parameter gradients, f32, in ``grad_floats``' layout). Two launches:
    the sequential part (``idepthmap_refiner_sequential``), then the weight-gradient pass
    (``idepthmap_refiner_wgrad``) on the maps it kept. The contract of
    ``idepthmap_refiner_backward_plain``."""
    dguid, didepth, gmaps, gout, gnpart = idepthmap_refiner_sequential(
        guidance, idepthmap, pack, dilations, out, raw, stats, hs, grad, need_guidance, tf32)
    return dguid, didepth, idepthmap_refiner_wgrad(guidance, idepthmap, dilations, hs, gmaps,
                                                   gout, gnpart, tf32)


def _unpack_grads(refiner, dparams: torch.Tensor) -> tuple:
    """The backward kernel's parameter gradients (``grad_floats``' layout) as a gradient
    for each of the refiner's ``named_parameters``."""
    cin = refiner.conv0.weight.shape[1]
    cin_pad = -(-cin // 4) * 4
    k0, kr = 9 * cin_pad * C, 9 * C * C
    w0 = dparams[:k0].reshape(9, cin_pad, C)[:, :cin]
    wr = dparams[k0:k0 + NUM_RES * kr].reshape(NUM_RES, 9, C, C)
    wf = dparams[k0 + NUM_RES * kr:k0 + NUM_RES * kr + 9 * C].reshape(9, C, 1)
    vec = dparams[k0 + NUM_RES * kr + 9 * C:]
    rows = vec[:-1].reshape(NUM_GN, 3, C)
    grads = []
    for k in range(NUM_GN):
        grads += [_untaps(w0 if k == 0 else wr[k - 1]), *rows[k]]
    return (*grads, _untaps(wf), vec[-1:])


def _launch_backward(refiner, guidance: torch.Tensor, idepthmap: torch.Tensor,
                     out: torch.Tensor, saved: tuple, grad: torch.Tensor, needs,
                     tf32: bool) -> tuple:
    """The backward kernel (``idepthmap_refiner_backward``) on what ``_launch(...,
    keep=True)`` saved; returns (d guidance at the guidance's dtype, d idepthmap, (d
    parameter for each of the refiner's ``named_parameters``)) as
    ``idepthmap_refiner_backward_plain`` does, None for what ``needs`` (guidance,
    idepthmap, the parameters) leaves out."""
    raw, stats, hs, pack = saved
    dguid, didepth, dparams = idepthmap_refiner_backward(
        guidance, idepthmap, pack, _dilations(refiner), out, raw, stats, hs, grad, needs[0],
        tf32)
    return (dguid.to(guidance.dtype) if needs[0] else None, didepth if needs[1] else None,
            _unpack_grads(refiner, dparams) if needs[2] else None)


class _IdepthmapRefiner(torch.autograd.Function):
    """K3 under autograd: the kernel forward, given every parameter of the refiner as an
    input so that autograd routes their gradients, keeping each GroupNorm layer's raw
    conv output and h and each GroupNorm's statistics (``keep``); the backward kernel
    from those (``_launch_backward``), launched once, and no forward kernel. It
    differentiates the kernel's own forward at the points where it rounded: at f32 the
    refiner's gradient within the 3xTF32 kernel's rounding (the 1xTF32 products after the
    1xTF32 forward), as the JAX custom VJP (``refiner_kernel.py:227-255``) differentiates
    ``idepthmap_refiner_s2d`` under the Pallas forward; at bf16 the gradient of the
    refiner as the bf16 kernel rounds it, the convs' gradient operands rounded to bf16,
    every other gradient f32 and the guidance's returned at bf16."""

    @staticmethod
    def forward(ctx, refiner, tf32, guidance, idepthmap, *params):
        ctx.refiner, ctx.tf32 = refiner, tf32
        out, (raw, stats, hs, pack) = _launch(refiner, guidance, idepthmap, tf32, keep=True)
        ctx.save_for_backward(guidance, idepthmap, out, raw, stats, hs)
        # The pack the forward ran on is held by the context: it may come from the cache
        # made under inference mode (a validation pass), which autograd refuses to save.
        ctx.pack = pack
        return out

    @staticmethod
    def backward(ctx, grad):
        guidance, idepthmap, out, raw, stats, hs = ctx.saved_tensors
        needs = ctx.needs_input_grad[2:]
        dg, di, params = _launch_backward(ctx.refiner, guidance, idepthmap, out,
                                          (raw, stats, hs, ctx.pack), grad,
                                          (needs[0], needs[1], any(needs[2:])), ctx.tf32)
        params = params or (None,) * len(needs[2:])
        return (None, None, dg, di, *(p if need else None for p, need in zip(params, needs[2:])))


def idepthmap_refiner_kernel(refiner, guidance: torch.Tensor, idepthmap: torch.Tensor,
                             tf32: bool = False) -> torch.Tensor:
    """The kernel on CUDA tensors (``tf32``: the 1xTF32 variant at f32 guidance):
    launched directly, or through ``_IdepthmapRefiner`` when autograd records."""
    if torch.is_grad_enabled():
        params = list(refiner.parameters())
        if needs_autograd(guidance, idepthmap, *params):
            return _IdepthmapRefiner.apply(refiner, tf32, guidance, idepthmap, *params)
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

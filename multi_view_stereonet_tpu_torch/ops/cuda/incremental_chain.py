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
which takes the refiner's weights as inputs; its forward also keeps each step's raw h
and raw r and its GroupNorms' statistics, and its backward launches the backward kernel
(``incremental_chain_backward``, counted in ``backward_launches``) on those: the VJP of
``_incremental_scan`` that the JAX ``_chain_bwd`` (``incremental_chain.py:357-368``)
takes by recomputing the scan. Its plain version in closed form is
``incremental_chain_backward_plain``, fed by the forward kernel's plain version
(``incremental_chain_saved_plain``) or by what the kernel kept. Keeping the raw maps
costs 2 x 1200 x 32 f32 a step and sample (27 MB at N = 8, D = 12, 30x40) and spares the
backward the forward's two convs and their GroupNorm statistics, with their cluster
barriers, again in every step.

At f32 storage the kernel has two variants: 3xTF32 (exact f32, the default) and 1xTF32
(``tf32``: one product of the TF32-rounded operands), which ``incremental_chain`` takes
inside a "tf32" precision scope (``ops/precision.py``; the "chain" stage at
``matmul_precision: high``). Its plain version is ``incremental_chain_tf32_plain``: the
loop with each conv operand rounded to TF32 as the kernel rounds it, then exact.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import precision
from ...geometry.projection import pixel_grid
from .build import (
    check_status, custom_op, launch_device, load_library, needs_autograd, tracing,
    use_kernel)
from .closed_form import (
    _conv_grads, _gn_backward, _gn_forward, _group_stats, _leaky, _nchw, _operand_round,
    _round_to)
from .warp import grid_sample_backward_plain, grid_sample_plain
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


# The FeatureRefiner's parameters in the order the plain forward and the closed form take
# them, each with its place in the kernels' layout: a conv's taps (its tap set, ``_taps``)
# or a row of the stacked bias and GroupNorm vectors (``vec``).
LAYOUT = (("conv0.weight", "taps", 0), ("conv0.bias", "vec", 0), ("bn0.weight", "vec", 1),
          ("bn0.bias", "vec", 2), ("res0.conv1.weight", "taps", 1),
          ("res0.conv1.bias", "vec", 3), ("res0.bn1.weight", "vec", 4),
          ("res0.bn1.bias", "vec", 5), ("conv_final.weight", "taps", 2),
          ("conv_final.bias", "vec", 6))


def _weights(refiner):
    params = dict(refiner.named_parameters())
    return tuple(params[name] for name, _, _ in LAYOUT)


def incremental_chain_saved_plain(refiner, feats0: torch.Tensor, image_rest: torch.Tensor,
                                  H_inc: torch.Tensor, tf32: bool = False) -> tuple:
    """The forward kernel's plain version under autograd: (out, raw, stats) at its rounding
    points, where out is the chain (N, D, h, w, 32) at feats0's dtype, raw (N, D-1, 2, h,
    w, 32) f32 each step's conv0 + b0 and resblock conv + br before their GroupNorms, and
    stats (N, D-1, 2, 2, 4) f32 each of those GroupNorms' (mean, rstd) per group. The
    tensors the backward reads; its convs at the kernel's operand rounding."""
    with torch.no_grad():
        return saved_forward([t.detach().float() for t in _weights(refiner)], feats0,
                             image_rest, H_inc, tf32)


def saved_forward(weights, feats0: torch.Tensor, image_rest: torch.Tensor,
                  H_inc: torch.Tensor, tf32: bool = False) -> tuple:
    """``incremental_chain_saved_plain`` on f32 ``weights`` in ``LAYOUT``'s order,
    differentiable in them and in feats0: plain autograd through the same forward that the
    closed-form backward reads."""
    dtype = feats0.dtype
    rnd = _operand_round(dtype, tf32)
    w0, b0, g0, be0, wr, br, gr, ber, wf, bf = weights
    h, w = feats0.shape[1], feats0.shape[2]
    feats = feats0.float()
    volume, raws, stats = [_round_to(dtype, feats)], [], []
    with precision.scope("ieee"):
        for d in range(H_inc.shape[1]):
            warped = _round_to(dtype, grid_sample_plain(
                feats, homography_grid(H_inc[:, d].float(), h, w), zero_invalid=True)[0])
            x0 = torch.cat([_round_to(dtype, image_rest[:, d].float()), warped], -1)
            a = F.conv2d(_nchw(rnd(x0)), rnd(w0), None, padding=1).permute(0, 2, 3, 1) + b0
            s0 = _group_stats(a)
            hn = _leaky(_gn_forward(a, s0, g0, be0)[1], dtype)
            r = F.conv2d(_nchw(rnd(hn)), rnd(wr), None, padding=1).permute(0, 2, 3, 1) + br
            sr = _group_stats(r)
            res = _round_to(dtype, hn + _leaky(_gn_forward(r, sr, gr, ber)[1], dtype))
            delta = F.conv2d(_nchw(rnd(res)), rnd(wf), None, padding=1).permute(0, 2, 3, 1)
            feats = _round_to(dtype, warped + (delta + bf))
            volume.append(feats)
            raws.append(torch.stack([a, r], 1))
            stats.append(torch.stack([s0, sr], 1))
    return (torch.stack(volume, 1).to(dtype), torch.stack(raws, 1).contiguous(),
            torch.stack(stats, 1).contiguous())


def homography_grid_backward(H: torch.Tensor, dgrid: torch.Tensor) -> torch.Tensor:
    """The gradient of ``homography_grid(H, h, w)`` in H (B, 3, 3), given the grid's
    (B, h, w, 2), in closed form: u = X / Z, v = Y / Z of (X, Y, Z) = H [x, y, 1], the
    normalization's 2 / w and 2 / h, summed over the pixels."""
    B, h, w, _ = dgrid.shape
    pix = pixel_grid(h, w, H.dtype, H.device).reshape(3, -1)
    X, Y, Z = (H.float() @ pix).unbind(1)
    du = dgrid[..., 0].reshape(B, -1) * (2.0 / w)
    dv = dgrid[..., 1].reshape(B, -1) * (2.0 / h)
    dxyz = torch.stack([du / Z, dv / Z, -(du * X + dv * Y) / (Z * Z)], 1)  # (B, 3, P)
    return dxyz @ pix.T


def incremental_chain_backward_plain(refiner, feats0: torch.Tensor, image_rest: torch.Tensor,
                                     H_inc: torch.Tensor, out: torch.Tensor, raw: torch.Tensor,
                                     stats: torch.Tensor, grad: torch.Tensor,
                                     needs=(True, True, True, True), tf32: bool = False
                                     ) -> tuple:
    """The backward kernel's plain version: the gradients (d feats0, d image_rest, d H_inc,
    (d parameter for each of the refiner's ``named_parameters``)) of the chain given its
    output's gradient ``grad``, in closed form over the forward's saved tensors (``out``,
    ``raw``, ``stats``, as ``incremental_chain_saved_plain`` gives them), the reverse loop
    of the kernel: steps d = D-2 .. 0, each conv_final's, the resblock's, then conv0's
    backward and the warp's transpose into the carry's gradient. None for what ``needs``
    (feats0, image_rest, H_inc, the parameters) leaves out. The convs' operands are rounded
    as the kernel's are (``_operand_round``); the elementwise terms are f32, the map sums
    f64."""
    dtype = feats0.dtype
    rnd = _operand_round(dtype, tf32)
    w0, b0, g0, be0, wr, br, gr, ber, wf, bf = (t.detach().float() for t in _weights(refiner))
    N, h, w, _ = feats0.shape
    grad = grad.float()
    dparams = [torch.zeros_like(t) for t in (w0, b0, g0, be0, wr, br, gr, ber, wf, bf)]
    dimage = torch.zeros(image_rest.shape, dtype=torch.float32, device=feats0.device)
    dH = torch.zeros(H_inc.shape, dtype=torch.float32, device=feats0.device)
    carry_grad = grad[:, -1]
    with torch.no_grad(), precision.scope("ieee"):
        for d in range(H_inc.shape[1] - 1, -1, -1):
            carry = out[:, d].float()
            grid = homography_grid(H_inc[:, d].float(), h, w)
            warped = _round_to(dtype, grid_sample_plain(carry, grid, zero_invalid=True)[0])
            x0 = torch.cat([_round_to(dtype, image_rest[:, d].float()), warped], -1)
            a, r = raw[:, d, 0], raw[:, d, 1]
            xh0, z0 = _gn_forward(a, stats[:, d, 0], g0, be0)
            xhr, zr = _gn_forward(r, stats[:, d, 1], gr, ber)
            hn = _leaky(z0, dtype)
            res = _round_to(dtype, hn + _leaky(zr, dtype))
            # conv_final; the resblock's GroupNorm and conv; GN0 and conv0.
            gres, dw = _conv_grads(res, wf, carry_grad, rnd)
            dparams[8] += dw
            dparams[9] += carry_grad.sum((0, 1, 2))
            dr, dg, db = _gn_backward(gres, zr, xhr, stats[:, d, 1], gr, dtype)
            dparams[6] += dg
            dparams[7] += db
            ghn, dw = _conv_grads(hn, wr, dr, rnd)
            ghn = ghn + gres
            dparams[4] += dw
            dparams[5] += dr.sum((0, 1, 2))
            da, dg, db = _gn_backward(ghn, z0, xh0, stats[:, d, 0], g0, dtype)
            dparams[2] += dg
            dparams[3] += db
            gx0, dw = _conv_grads(x0, w0, da, rnd)
            dparams[0] += dw
            dparams[1] += da.sum((0, 1, 2))
            dimage[:, d] = gx0[..., :3]
            gwarped = carry_grad + gx0[..., 3:]
            dcarry, dgrid = grid_sample_backward_plain(carry, grid, gwarped, True,
                                                       (True, needs[2]))
            if needs[2]:
                dH[:, d] = homography_grid_backward(H_inc[:, d], dgrid)
            carry_grad = grad[:, d] + dcarry
    names = [name for name, _ in refiner.named_parameters()]
    by_name = dict(zip((name for name, _, _ in LAYOUT), dparams))
    return (carry_grad.to(dtype) if needs[0] else None,
            dimage.to(image_rest.dtype) if needs[1] else None,
            dH.to(H_inc.dtype) if needs[2] else None,
            tuple(by_name[n] for n in names) if needs[3] else None)


# The storage dtypes the kernel takes, and each one's entry in csrc/incremental_chain.cu;
# TF32_ENTRY is the f32 storage's 1xTF32 variant. BACKWARD and TF32_BACKWARD: the
# backward kernel's.
ENTRIES = {torch.float32: "mvs_incremental_chain_f32",
           torch.bfloat16: "mvs_incremental_chain_bf16"}
TF32_ENTRY = "mvs_incremental_chain_tf32"
BACKWARD = {torch.float32: "mvs_incremental_chain_bwd_f32",
            torch.bfloat16: "mvs_incremental_chain_bwd_bf16"}
TF32_BACKWARD = "mvs_incremental_chain_bwd_tf32"
backward_launches = 0  # the backward kernel's launches since the last reset


def _entry(dtype: torch.dtype, tf32: bool) -> str:
    """The kernel entry for storage ``dtype``: 1xTF32 where ``tf32`` and the storage is
    f32; bf16 storage takes its bf16 variant at every precision."""
    return TF32_ENTRY if tf32 and dtype == torch.float32 else ENTRIES[dtype]


def _library():
    lib = load_library("incremental_chain")
    if lib.mvs_incremental_chain_f32.argtypes is None:
        for name in (*ENTRIES.values(), TF32_ENTRY):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        for name in (*BACKWARD.values(), TF32_BACKWARD):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
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


def _untaps(taps: torch.Tensor) -> torch.Tensor:
    """(9, Cin, Cout) tap-major -> the OIHW 3x3 conv weight (``_taps``'s inverse)."""
    return taps.reshape(3, 3, taps.shape[1], taps.shape[2]).permute(3, 2, 0, 1).contiguous()


def _weight_args(refiner) -> tuple:
    """The refiner's weights as the kernels take them (``LAYOUT``): conv0's, the
    resblock's and conv_final's taps, and the seven bias and GroupNorm vectors stacked
    (``vec``)."""
    weights = _weights(refiner)
    taps = {i: _taps(t) for (_, kind, i), t in zip(LAYOUT, weights) if kind == "taps"}
    vec = {i: t for (_, kind, i), t in zip(LAYOUT, weights) if kind == "vec"}
    return (*(taps[i] for i in range(3)), torch.stack([vec[i] for i in range(len(vec))]))


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


def _forward_launch(feats0: torch.Tensor, image_rest: torch.Tensor, H_inc: torch.Tensor,
                    w0: torch.Tensor, wr: torch.Tensor, wf: torch.Tensor, vec: torch.Tensor,
                    cluster: int, tf32: bool = False, keep: bool = False) -> tuple:
    """Launch csrc/incremental_chain.cu: one thread-block cluster per sample runs all D-1
    steps, at feats0's dtype (f32 storage: 1xTF32 where ``tf32``, else 3xTF32). The
    refiner's conv weights come as f32 taps (``_taps``; the bf16 kernel rounds them to
    bf16 as it loads them), its seven bias and GroupNorm vectors stacked in ``vec``.
    Returns (out, raw, stats): with ``keep`` (under autograd) the kernel also writes what
    the backward reads, each step's raw h and raw r (N, D-1, 2, h, w, 32) and its
    GroupNorms' mean and rstd (N, D-1, 2, 2, 4), f32; else those are None."""
    global launches, tf32_launches
    out = _output(feats0, image_rest, H_inc, w0, wr, wf, vec)
    N, h, w, C = feats0.shape
    Dm1 = H_inc.shape[1]
    feats0 = feats0.contiguous()
    if feats0.data_ptr() % 16:  # the kernel reads it as float4
        feats0 = feats0.clone()
    image_rest, H_inc = image_rest.contiguous(), H_inc.contiguous()
    w0, wr, wf, vec = w0.contiguous(), wr.contiguous(), wf.contiguous(), vec.contiguous()
    f32 = dict(dtype=torch.float32, device=feats0.device)
    scratch = torch.empty((N, 3, h, w, C), **f32)
    raw = torch.empty((N, Dm1, 2, h, w, C), **f32) if keep else None
    stats = torch.empty((N, Dm1, 2, 2, 4), **f32) if keep else None
    stream = torch.cuda.current_stream(feats0.device).cuda_stream
    entry = _entry(feats0.dtype, tf32)
    with launch_device(feats0.device):
        status = getattr(_library(), entry)(
            feats0.data_ptr(), image_rest.data_ptr(), H_inc.data_ptr(), w0.data_ptr(),
            wr.data_ptr(), wf.data_ptr(), vec.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), raw.data_ptr() if keep else 0,
            stats.data_ptr() if keep else 0, N, Dm1, h, w, cluster, stream)
    check_status(entry, status)
    launches += 1
    tf32_launches += entry == TF32_ENTRY
    return out, raw, stats


def _incremental_chain_launch(feats0: torch.Tensor, image_rest: torch.Tensor,
                              H_inc: torch.Tensor, w0: torch.Tensor, wr: torch.Tensor,
                              wf: torch.Tensor, vec: torch.Tensor,
                              cluster: int, tf32: bool = False) -> torch.Tensor:
    """The forward kernel's output alone (``_forward_launch`` without ``keep``)."""
    return _forward_launch(feats0, image_rest, H_inc, w0, wr, wf, vec, cluster, tf32)[0]


_incremental_chain_op = custom_op("incremental_chain",
                                  "incremental_chain")(_incremental_chain_launch)
_incremental_chain_op.register_fake(
    lambda feats0, image_rest, H_inc, w0, wr, wf, vec, cluster, tf32=False: _output(
        feats0, image_rest, H_inc, w0, wr, wf, vec))


def _launch(refiner, feats0: torch.Tensor, image_rest: torch.Tensor, H_inc: torch.Tensor,
            cluster: int, tf32: bool, keep: bool = False):
    """The kernel on CUDA tensors; while ``torch.export`` traces, through the custom op
    ``mvs_torch::incremental_chain`` (see build.py ``custom_op``). ``cluster`` sets the
    blocks a sample (0: the kernel chooses, see ``cluster_size``); a size the card refuses
    raises. With ``keep`` (under autograd) it returns (out, raw, stats) as
    ``_forward_launch`` does, else out."""
    if not feats0.is_cuda:
        raise ValueError("incremental_chain_kernel needs every tensor and weight "
                         "on one CUDA device")
    args = (feats0, image_rest.to(feats0.dtype), H_inc, *_weight_args(refiner), cluster, tf32)
    if keep:
        return _forward_launch(*args, keep=True)
    return (_incremental_chain_op if tracing() else _incremental_chain_launch)(*args)


def incremental_chain_backward(image_rest: torch.Tensor, H_inc: torch.Tensor,
                               w0: torch.Tensor, wr: torch.Tensor, wf: torch.Tensor,
                               vec: torch.Tensor, out: torch.Tensor, raw: torch.Tensor,
                               stats: torch.Tensor, grad: torch.Tensor,
                               needs=(True, True, True), cluster: int = 0,
                               tf32: bool = False) -> tuple:
    """The backward kernel of csrc/incremental_chain.cu on CUDA tensors: from the forward's
    inputs (image_rest at the storage dtype, H_inc, the weights as ``_weight_args`` gives
    them), its output ``out``, what it kept (``raw``, ``stats``) and the output's gradient
    ``grad``, the gradients (d feats0, d image_rest, d H_inc, d conv0 taps, d resblock
    taps, d conv_final taps, d vec), all f32; d image_rest and d H_inc None where
    ``needs`` (feats0, image_rest, H_inc) leaves them out. One launch: a thread-block
    cluster a sample (``cluster`` blocks, 0: ``cluster_size``'s), each block writing its
    own parameter gradients (and H's) into a slot of its own, which are then summed over
    the blocks in a fixed order (one reduction). The contract of
    ``incremental_chain_backward_plain``."""
    global backward_launches
    dtype = out.dtype
    tensors = (image_rest, H_inc, w0, wr, wf, vec, out, raw, stats, grad)
    if not all(t.is_cuda and t.device == out.device for t in tensors):
        raise ValueError("incremental_chain_backward needs every tensor on one CUDA device")
    if (dtype not in BACKWARD or image_rest.dtype != dtype or grad.dtype != dtype
            or any(t.dtype != torch.float32 for t in (H_inc, w0, wr, wf, vec, raw, stats))):
        raise TypeError("incremental_chain_backward takes image_rest, out and grad at the "
                        "storage dtype and everything else float32")
    N, D, h, w, C = out.shape
    Dm1 = D - 1
    if (grad.shape != out.shape or raw.shape != (N, Dm1, 2, h, w, C)
            or stats.shape != (N, Dm1, 2, 2, 4) or image_rest.shape != (N, Dm1, h, w, 3)
            or H_inc.shape != (N, Dm1, 3, 3)):
        raise ValueError(f"bad shapes: out {tuple(out.shape)}, grad {tuple(grad.shape)}, raw "
                         f"{tuple(raw.shape)}, stats {tuple(stats.shape)}")
    cluster = cluster or cluster_size(N, h, w, out.device)
    f32 = dict(dtype=torch.float32, device=out.device)
    dfeats0 = torch.empty((N, h, w, C), **f32)
    dimage = torch.empty((N, Dm1, h, w, 3), **f32) if needs[1] else None
    dH = torch.empty((N, Dm1, cluster, 9), **f32) if needs[2] else None
    partial = torch.empty((N * cluster, 9 * 35 * 32 + 2 * 9 * 32 * 32 + 7 * 32), **f32)
    scratch = torch.empty((N, 4, h, w, C), **f32)
    args = [t.contiguous() for t in tensors]
    entry = TF32_BACKWARD if tf32 and dtype == torch.float32 else BACKWARD[dtype]
    stream = torch.cuda.current_stream(out.device).cuda_stream
    with launch_device(out.device):
        status = getattr(_library(), entry)(
            *(t.data_ptr() for t in args), dfeats0.data_ptr(),
            0 if dimage is None else dimage.data_ptr(), 0 if dH is None else dH.data_ptr(),
            partial.data_ptr(), scratch.data_ptr(), N, Dm1, h, w, cluster, stream)
    check_status(entry, status)
    backward_launches += 1
    sums = partial.sum(0)
    k0, kr = 9 * 35 * 32, 9 * 32 * 32
    return (dfeats0, dimage, None if dH is None else dH.sum(2).reshape(N, Dm1, 3, 3),
            sums[:k0].reshape(9, 35, 32), sums[k0:k0 + kr].reshape(9, 32, 32),
            sums[k0 + kr:k0 + 2 * kr].reshape(9, 32, 32), sums[k0 + 2 * kr:].reshape(7, 32))


def _launch_backward(refiner, image_rest: torch.Tensor, H_inc: torch.Tensor, weights,
                     out: torch.Tensor, raw: torch.Tensor, stats: torch.Tensor,
                     grad: torch.Tensor, needs, cluster: int, tf32: bool) -> tuple:
    """The backward kernel (``incremental_chain_backward``) with the refiner's ``weights``
    as ``_weight_args`` gave them to the forward; returns (d feats0, d image_rest,
    d H_inc, (d parameter for each of the refiner's ``named_parameters``)) in f32, as
    ``incremental_chain_backward_plain`` does."""
    df, di, dH, *grads = incremental_chain_backward(image_rest, H_inc, *weights, out, raw,
                                                    stats, grad, needs[:3], cluster, tf32)
    place = {name: (kind, i) for name, kind, i in LAYOUT}
    params = []
    for name, _ in refiner.named_parameters():
        kind, i = place[name]
        params.append(_untaps(grads[i]) if kind == "taps" else grads[3][i])
    return df, di, dH, tuple(params)


class _IncrementalChain(torch.autograd.Function):
    """K2 under autograd: the kernel forward, given the refiner's weights as inputs so
    that autograd routes their gradients, keeping each step's raw h and raw r and its
    GroupNorms' statistics (``keep``); the backward kernel from those
    (``_launch_backward``), launched once, and no forward kernel. The backward
    differentiates the kernel's own forward at the points where it rounded: at f32 that is
    the scan's gradient within the 3xTF32 kernel's rounding (the 1xTF32 convs after the
    1xTF32 forward), as the JAX custom VJP (``incremental_chain.py:351-371``)
    differentiates ``_incremental_scan`` under the Pallas forward. At bf16 it is the
    gradient of the chain as the kernel rounds it (the warp in f32, rounded once, as the
    Pallas kernel does; the convs' gradient operands rounded to bf16, every other
    gradient f32), not the JAX custom VJP's bf16 gradient of the scan, whose warp
    interpolates at bf16 and whose gradients are each rounded to bf16: the two lie up to
    0.25 of max apart (chip_smoke.py ``CHAIN_LEGS``). The bf16 recipe trains alike under
    either gradient (``scripts/k2_bf16_convergence_torch.py``: the best validation EPE of
    Run A's recipe with the backward by plain autograd lies within the spread of two runs
    through this Function; ``docs/convergence_torch/k2_bf16/``)."""

    @staticmethod
    def forward(ctx, refiner, cluster, tf32, feats0, image_rest, H_inc, *params):
        ctx.refiner, ctx.cluster, ctx.tf32 = refiner, cluster, tf32
        ctx.dtypes = (feats0.dtype, image_rest.dtype)
        out, raw, stats = _launch(refiner, feats0, image_rest, H_inc, cluster, tf32,
                                  keep=True)
        ctx.save_for_backward(image_rest.to(feats0.dtype), H_inc, out, raw, stats,
                              *_weight_args(refiner))
        return out

    @staticmethod
    def backward(ctx, grad):
        image, H_inc, out, raw, stats, *weights = ctx.saved_tensors
        needs = ctx.needs_input_grad[3:]
        df, di, dH, params = _launch_backward(ctx.refiner, image, H_inc, weights, out, raw,
                                              stats, grad.to(ctx.dtypes[0]), needs,
                                              ctx.cluster, ctx.tf32)
        return (None, None, None, df.to(ctx.dtypes[0]) if needs[0] else None,
                di.to(ctx.dtypes[1]) if needs[1] else None, dH if needs[2] else None,
                *(p if need else None for p, need in zip(params, needs[3:])))


def incremental_chain_kernel(refiner, feats0: torch.Tensor, image_rest: torch.Tensor,
                             H_inc: torch.Tensor, cluster: int = 0,
                             tf32: bool = False) -> torch.Tensor:
    """The kernel on CUDA tensors (``cluster`` as in ``_launch``; ``tf32``: the 1xTF32
    variant at f32 storage): launched directly, or through ``_IncrementalChain`` when
    autograd records."""
    if torch.is_grad_enabled():
        params = list(refiner.parameters())
        if needs_autograd(feats0, image_rest, H_inc, *params):
            return _IncrementalChain.apply(refiner, cluster, tf32, feats0, image_rest, H_inc,
                                           *params)
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

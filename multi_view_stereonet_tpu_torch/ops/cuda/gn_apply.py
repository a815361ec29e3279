"""GroupNorm -> LeakyReLU(0.2) -> optional residual add: CUDA kernels
(csrc/gn_apply.cu), forward and backward, and their plain versions. Every
GroupNorm of the forward on the card goes through it: the resblock tails (with
the residual), the refiners' ``bn0`` and the cost filter's four (without).

Port of the TPU kernel ``multi_view_stereonet_tpu/ops/pallas/gn_apply.py``
(``gn_apply_residual_fused``) together with the statistics it takes from
``models/s2d.py`` ``gn_s2d_stats``: one call computes the statistics of x and
applies them. Layout NCHW or NCDHW (the port's modules' own), f32 or bf16 x and
res (gamma, beta and the statistics f32), eps 1e-5 (the port's
``GroupNorm(C // 8)``). At bf16 it follows the Pallas kernel's rounding
(``gn_apply.py:37-52``): the apply in f32, rounded to bf16, the sign test on
the f32 value, then LeakyReLU and the residual add at bf16. ``xbias`` (f32, per
channel), the bias of the conv that wrote x, is added to x in f32 first: a bf16 conv's
bias is then never rounded before its GroupNorm, as the Pallas kernels add it in f32
and as XLA computes the JAX layers' ``conv + b`` there.

How a call runs is decided before its launch by ``plan``, from the shape, the dtype
and the card's SM count alone. The forward is a statistics pass over chunks of each
(sample, group) row and an apply pass ("chunked"). Under autograd the kernel runs in
``_GroupNormAct``: its forward also writes each row's f32 mean and rstd, and its
backward launches the backward kernel from them (``group_norm_act_backward``, whose
plain version in closed form is ``group_norm_act_backward_plain``): one cooperative
launch that holds x and the gradient in the shared memory of up to one block an SM, the
whole call at once where it fits ("resident"), else at f32 in waves of whole (sample,
group) rows, each held between its two passes ("waves"), and at bf16, or where little
would be read twice, in one wave whose rest is read twice ("partial"). The residual's
gradient is the output's. A launch the card refuses raises; nothing retries on another
route. The JAX ``_bwd`` (``gn_apply.py:120-126``) takes the VJP of ``_xla_reference``
instead. Backward launches count in ``backward_launches``, so ``launches`` counts
forwards only.
"""

from __future__ import annotations

import collections
import ctypes
import math

import torch
import torch.nn.functional as F

from .build import (
    barrier_counter, check_status, custom_op, launch_device, load_library, needs_autograd,
    tracing, use_kernel)

# Kernel launches since the last reset; only the kernel path counts, one per call (a
# forward's one or two launches count once). backward_launches counts the backward
# kernel's.
launches = 0
backward_launches = 0

EPS = 1e-5
SLOPE = 0.2
# The forward's statistics pass aims at BLOCKS_PER_SM blocks per SM in all and gives each
# at least MIN_CHUNK elements of its row.
BLOCKS_PER_SM = 4
MIN_CHUNK = 4096
# The backward kernel (csrc/gn_apply.cu): shared memory a block holds its slices of x and
# dy in (HOLD_BYTES there); the bytes of x and dy a block gets at least, so that a small
# call takes few blocks to its grid barrier; the bytes of a wave, over the card, that may
# go beyond what the blocks hold and be read again from L2.
HOLD_BYTES = 224 * 1024
SLICE_BYTES = 32 * 1024
REREAD_BYTES = 12 * 2 ** 20
# The bytes of x and dy one wave over the card would read twice, at most, for the backward
# to stay in one wave ("partial") at f32: below them the waves' barriers cost more.
WAVES_BYTES = 64 * 2 ** 20
MAX_VALUES = 2 ** 31  # the backward kernel indexes values in 31 bits

_PTR, _INT, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# The storage dtypes the kernels take, and each one's entries in csrc/gn_apply.cu.
FORWARD = {torch.float32: "mvs_gn_act_f32", torch.bfloat16: "mvs_gn_act_bf16"}
BACKWARD = {torch.float32: "mvs_gn_act_bwd_f32", torch.bfloat16: "mvs_gn_act_bwd_bf16"}
_ARGS = {
    "forward": [_PTR] * 8 + [_INT] * 3 + [_I64, _I64, _INT, _INT, ctypes.c_float, _PTR],
    "backward": [_PTR] * 13 + [_INT] * 3 + [_I64, _INT, _INT, _I64, _I64, _INT, _PTR]}
# Per device index: (SM count, {entry name: ctypes entry}).
_device_cache: dict = {}

Plan = collections.namedtuple("Plan", "route blocks slice held waves", defaults=(1,))
Plan.__doc__ = """How one call runs: ``route`` ("chunked" for the forward, "resident",
"partial" or "waves" for the backward); for the forward ``blocks`` chunks of ``slice``
values a (sample, group) row; for the backward ``waves`` waves of whole (sample, group)
rows, each cut into ``blocks`` slices (``wave_slices``; ``slice``: the longest), each
block holding the first ``held`` values of its slice of x and of dy in shared memory."""


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """LeakyReLU(0.2) at x's dtype. Below f32, as the JAX ``leaky_relu`` computes it
    there: the slope rounded to x's dtype, the product rounded once."""
    if x.dtype == torch.float32:
        return F.leaky_relu(x, SLOPE)
    return torch.where(x >= 0, x, x * torch.tensor(SLOPE, dtype=x.dtype).item())


def group_norm_act_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                         groups: int, res: torch.Tensor | None = None,
                         xbias: torch.Tensor | None = None) -> torch.Tensor:
    """leaky_relu(group_norm(x [+ xbias]), 0.2) (+ res), as ``nn.GroupNorm`` computes it.
    Below f32, as the JAX ``group_norm`` does there: x (and xbias) summed, the statistics
    and the apply in f32, rounded to x's dtype, then LeakyReLU and the residual at that
    dtype."""
    if x.dtype == torch.float32 and xbias is None:
        y = F.leaky_relu(F.group_norm(x, groups, weight, bias, EPS), SLOPE)
    else:
        x32 = x.float()
        if xbias is not None:
            x32 = x32 + xbias.float().reshape((-1,) + (1,) * (x.ndim - 2))
        y = leaky_relu(F.group_norm(x32, groups, weight.float(), bias.float(),
                                    EPS).to(x.dtype))
    return y if res is None else y + res


def _biased(x: torch.Tensor, xbias: torch.Tensor | None) -> torch.Tensor:
    """x (N, C, ...) as f32 (N, C, S), xbias added in f32."""
    v = x.float().reshape(x.shape[0], x.shape[1], -1)
    return v if xbias is None else v + xbias.float().reshape(1, -1, 1)


def group_stats_plain(x: torch.Tensor, groups: int,
                      xbias: torch.Tensor | None = None) -> torch.Tensor:
    """(N * groups, 2) f32: the mean and rstd = 1 / sqrt(var + eps) of each (sample,
    group) row of x [+ xbias], summed in f64 as the kernels sum them: the statistics the
    forward writes under autograd."""
    v = _biased(x, xbias).double().reshape(x.shape[0] * groups, -1)
    mean = v.mean(1)
    var = ((v * v).mean(1) - mean * mean).clamp_min(0.0)
    return torch.stack([mean, 1.0 / torch.sqrt(var + EPS)], 1).float()


def group_norm_act_backward_plain(x: torch.Tensor, weight: torch.Tensor,
                                  bias: torch.Tensor, groups: int, stats: torch.Tensor,
                                  grad: torch.Tensor, xbias: torch.Tensor | None = None
                                  ) -> tuple:
    """The gradients (dx, dweight, dbias, dxbias) of ``group_norm_act`` at x, given the
    forward's ``stats`` (``group_stats_plain``) and the output's gradient ``grad``, in
    closed form as the backward kernel computes them (dxbias None without xbias; the
    residual's gradient is ``grad`` itself). With x_hat = (x + xbias - mean) * rstd,
    z = x_hat * weight + bias and g = grad * leaky'(z) (at bf16 as plain autograd
    differentiates ``leaky_relu`` there: the sign test on z rounded to bf16, grad times the
    bf16 slope rounded to bf16): per row a = mean(g weight), b = mean(g weight x_hat),
    dx = rstd (g weight - a - x_hat b) rounded to x's dtype; dbias = sum g, dweight =
    sum g x_hat, dxbias = sum dx over samples and positions. Sums in f64, the elementwise
    terms in f32."""
    N, C = x.shape[:2]
    cg = C // groups
    xh = (_biased(x, xbias) - stats[:, 0].float().repeat_interleave(cg).reshape(N, C, 1)) \
        * stats[:, 1].float().repeat_interleave(cg).reshape(N, C, 1)
    w, b = weight.float().reshape(1, C, 1), bias.float().reshape(1, C, 1)
    z = xh * w + b
    dy = grad.float().reshape(N, C, -1)
    if x.dtype == torch.float32:
        g = torch.where(z > 0, dy, dy * SLOPE)
    else:
        slope = torch.tensor(SLOPE, dtype=x.dtype).item()
        g = torch.where(z.to(x.dtype) >= 0, dy, (dy * slope).to(x.dtype).float())
    G, GX, X = g.double().sum(2), (g.double() * xh.double()).sum(2), xh.double().sum(2)
    span = xh.shape[2]
    w64 = weight.double().reshape(1, C)
    a = (w64 * G).reshape(N, groups, cg).sum(2) / (cg * span)
    bb = (w64 * GX).reshape(N, groups, cg).sum(2) / (cg * span)
    a_c, b_c = a.repeat_interleave(cg, 1), bb.repeat_interleave(cg, 1)
    rs = stats[:, 1].double().repeat_interleave(cg).reshape(N, C)
    dx = rs.float()[..., None] * ((g * w - a_c.float()[..., None])
                                  - xh * b_c.float()[..., None])
    dxbias = None
    if xbias is not None:
        dxbias = (rs * (w64 * G - span * a_c - b_c * X)).sum(0).float()
    return (dx.reshape(x.shape).to(x.dtype), GX.sum(0).float(), G.sum(0).float(), dxbias)


def chunking(rows: int, L: int, target_blocks: int) -> tuple:
    """(chunk, chunks): each of ``rows`` rows of L floats cut into chunks of a multiple
    of 4 elements, about ``target_blocks`` in all, none under MIN_CHUNK unless the row
    is; chunks * chunk >= L and no chunk is empty."""
    chunks = max(1, min(-(-target_blocks // rows), -(-L // MIN_CHUNK)))
    chunk = -(-L // chunks)
    chunk = -(-chunk // 4) * 4
    return chunk, -(-L // chunk)


def _slice(values: int, blocks: int) -> int:
    """The values of a backward slice: ``values`` over ``blocks``, rounded up to a
    multiple of 8 (the kernel's ``wave``)."""
    return (-(-values // blocks) + 7) // 8 * 8


def wave_slices(shape, groups: int, p: Plan) -> list:
    """[(e0, e1, q)] a wave of the backward ``p`` at x of ``shape``: wave w's values
    [e0, e1), the rows [w * rows / waves, (w + 1) * rows / waves) of the N * groups
    (sample, group) rows, cut into ``p.blocks`` slices of q values (block b's: [e0 + b q,
    min(e1, e0 + (b + 1) q)), maybe empty), as csrc/gn_apply.cu ``wave`` cuts them."""
    rows = shape[0] * groups
    L = math.prod(shape) // rows
    out = []
    for w in range(p.waves):
        e0, e1 = w * rows // p.waves * L, (w + 1) * rows // p.waves * L
        out.append((e0, e1, _slice(e1 - e0, p.blocks)))
    return out


def plan(shape, groups: int, dtype: torch.dtype, sms: int, backward: bool = False,
         reread: int = REREAD_BYTES, hold: int = HOLD_BYTES,
         partial: int = WAVES_BYTES) -> Plan:
    """How K4 runs a call on x of ``shape`` (N, C, ...) and storage ``dtype`` on a card of
    ``sms`` SMs: the forward or, with ``backward``, the backward kernel. The rule, from
    these alone:

    - the forward: each (sample, group) row cut by ``chunking`` over BLOCKS_PER_SM * sms
      blocks ("chunked");
    - the backward, with ``cap`` the values of x (and of dy) a block holds (``hold``, at
      most HOLD_BYTES, over the bytes of a value of x and one of dy, a multiple of 8):
      "resident" where the whole call fits, ``blocks`` = the bytes of x and dy over
      SLICE_BYTES, rounded up, at least 1 and at most ``sms`` (``sms`` where fewer do not
      hold it), each holding its whole slice. Else ``sms`` blocks: "partial", one wave,
      where its slices go beyond ``cap`` by at most ``partial`` bytes of x and dy over the
      card (that rest of each slice read twice), and at bf16 storage whatever the
      excess; else "waves", the fewest waves of whole rows (balanced, at most N * groups)
      whose longest slice goes beyond ``cap`` by at most ``reread`` bytes over the card
      (by a row's share where one row alone does). A wave costs two grid-wide phases and
      a barrier; at bf16 it holds twice the values for the same bytes, so its f64 sums
      cost more than the second read it saves. On an H100 the waves lost to one wave at
      bf16 (the recipe's 480x640 and 240x320 calls) and at f32 (1, 32, 480, 640), and won
      9% at the recipe's f32 480x640 and 240x320 (PERF.md §6). It raises at
      MAX_VALUES values."""
    N = shape[0]
    E = math.prod(shape)
    if not backward:
        chunk, chunks = chunking(N * groups, E // max(1, N * groups), BLOCKS_PER_SM * sms)
        return Plan("chunked", chunks, chunk, 0)
    if E >= MAX_VALUES:
        raise ValueError(f"the GroupNorm backward kernel takes fewer than {MAX_VALUES} "
                         f"values, got {tuple(shape)}")
    size = torch.empty((), dtype=dtype).element_size()
    cap = min(hold, HOLD_BYTES) // (size * 2) // 8 * 8
    blocks = max(1, min(sms, -(-E * size * 2 // SLICE_BYTES)))
    if _slice(max(E, 1), blocks) > cap:
        blocks = sms
    q = _slice(max(E, 1), blocks)
    if q <= cap:
        blocks = -(-max(E, 1) // q)
        q = _slice(max(E, 1), blocks)
        return Plan("resident", blocks, q, q)
    if (q - cap) * size * 2 * sms <= partial or size < 4:
        return Plan("partial", sms, q, cap)
    extra = reread // (size * 2 * sms)  # values a block of a wave may read twice
    rows = N * groups
    waves = -(-rows // max(1, (cap + extra) // 8 * 8 * sms // (E // rows)))
    q = max(s[2] for s in wave_slices(shape, groups, Plan("", sms, 0, 0, waves)))
    return Plan("waves", sms, q, min(q, cap), waves)


def _device_functions(device: int) -> tuple:
    info = _device_cache.get(device)
    if info is None:
        lib = load_library("gn_apply")
        fns = {}
        for kind, names in (("forward", FORWARD), ("backward", BACKWARD)):
            for name in names.values():
                fn = fns[name] = getattr(lib, name)
                fn.argtypes, fn.restype = _ARGS[kind], ctypes.c_int
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        info = _device_cache[device] = (sms, fns)
    return info


def sm_count(device: torch.device) -> int:
    """The SM count of ``device``, as ``plan`` takes it (the kernels' library loaded)."""
    return _device_functions(device.index)[0]


def _output(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
            res: torch.Tensor | None, groups: int,
            xbias: torch.Tensor | None = None) -> torch.Tensor:
    """Check the inputs' devices, types and shapes; allocate the (contiguous) output."""
    vectors = (weight, bias) if xbias is None else (weight, bias, xbias)
    tensors = (x, *vectors) if res is None else (x, *vectors, res)
    if any(t.device != x.device for t in tensors):
        raise ValueError("group_norm_act_kernel needs x, weight, bias (and res, xbias) on "
                         "one device")
    if (x.dtype not in FORWARD or (res is not None and res.dtype != x.dtype)
            or any(t.dtype != torch.float32 for t in vectors)):
        raise TypeError("group_norm_act_kernel takes x (and res) float32 or bfloat16 and "
                        f"float32 weight, bias (and xbias), got x {x.dtype}, res "
                        f"{None if res is None else res.dtype}, weight {weight.dtype}, bias "
                        f"{bias.dtype}")
    C = x.shape[1] if x.ndim >= 3 else 0
    if (x.ndim not in (4, 5) or (res is not None and res.shape != x.shape) or groups < 1
            or C % groups or any(t.shape != (C,) for t in vectors)):
        raise ValueError(f"bad shapes: x {tuple(x.shape)}, res "
                         f"{None if res is None else tuple(res.shape)}, weight "
                         f"{tuple(weight.shape)}, bias {tuple(bias.shape)}, groups {groups}")
    return x.new_empty(x.shape)


def _vec(span: int, *tensors, width: int = 4) -> int:
    """``width`` (elements) where ``span`` and every tensor's address take vectors of that
    many elements, else 1. The forward takes 4-element vectors, the backward 16-byte ones
    (``_vec16``)."""
    return width if span % width == 0 and not any(
        t.data_ptr() % (width * t.element_size()) for t in tensors) else 1


def _vec16(span: int, *tensors) -> int:
    return _vec(span, *tensors, width=16 // tensors[0].element_size())


def _slots(shape, groups: int, p: Plan) -> int:
    """Partial slots of a backward launch ``p``: one a (sample, channel, block it meets),
    as many blocks as a span meets at most in a wave."""
    span = math.prod(shape[2:])
    q = min(s[2] for s in wave_slices(shape, groups, p))
    return shape[0] * shape[1] * (-(-span // q) + 1)


def _forward_launch(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    res: torch.Tensor | None, groups: int, xbias: torch.Tensor | None = None,
                    stats: bool = False):
    """Launch the forward on CUDA tensors as ``plan`` cuts it; with ``stats`` also return
    the (N * groups, 2) f32 mean and rstd it applied. A launch the card refuses raises."""
    global launches
    out = _output(x, weight, bias, res, groups, xbias)
    if not x.is_contiguous():
        x = x.contiguous()
    if res is not None and not res.is_contiguous():
        res = res.contiguous()
    if not (weight.is_contiguous() and bias.is_contiguous()):
        weight, bias = weight.contiguous(), bias.contiguous()
    if xbias is not None:
        xbias = xbias.contiguous()
    dev = x.get_device()
    N, C, span = x.shape[0], x.shape[1], math.prod(x.shape[2:])
    operands = (x, out) if res is None else (x, out, res)
    sms, fns = _device_functions(dev)
    p = plan(x.shape, groups, x.dtype, sms)
    st = torch.empty((N * groups, 2), dtype=torch.float32, device=x.device) if stats else None
    partials = torch.empty((N * groups, p.blocks, 2), dtype=torch.float64, device=x.device)
    name = FORWARD[x.dtype]
    with launch_device(x.device):
        status = fns[name](
            x.data_ptr(), None if xbias is None else xbias.data_ptr(),
            None if res is None else res.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            out.data_ptr(), None if st is None else st.data_ptr(), partials.data_ptr(), N, C,
            groups, span, p.slice, p.blocks, _vec(span, *operands), EPS,
            torch._C._cuda_getCurrentRawStream(dev))
    check_status(name, status)
    launches += 1
    return (out, st) if stats else out


def _group_norm_act_launch(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                           res: torch.Tensor | None, groups: int,
                           xbias: torch.Tensor | None = None) -> torch.Tensor:
    """Launch csrc/gn_apply.cu's forward on CUDA tensors (a statistics pass, then an
    apply pass). A launch the card refuses raises."""
    return _forward_launch(x, weight, bias, res, groups, xbias)


_group_norm_act_op = custom_op("group_norm_act", "gn_apply")(_group_norm_act_launch)
_group_norm_act_op.register_fake(_output)
# On the CPU the op is the plain version, so that torch.library.opcheck runs there too;
# the wrappers send CPU tensors to the plain version directly.
_group_norm_act_op.register_kernel("cpu")(
    lambda x, weight, bias, res, groups, xbias=None: group_norm_act_plain(
        x, weight, bias, groups, res, xbias))


def _launch(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int,
            res: torch.Tensor | None, xbias: torch.Tensor | None, stats: bool = False):
    """The kernel on CUDA tensors (with ``stats``, also the statistics it applied); while
    ``torch.export`` traces, through the custom op ``mvs_torch::group_norm_act`` (see
    build.py ``custom_op``)."""
    if not x.is_cuda:
        raise ValueError("group_norm_act_kernel needs x, weight, bias (and res) on one "
                         "CUDA device")
    if stats:
        return _forward_launch(x, weight, bias, res, groups, xbias, stats=True)
    return (_group_norm_act_op if tracing() else _group_norm_act_launch)(
        x, weight, bias, res, groups, xbias)


def group_norm_act_backward(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                            groups: int, stats: torch.Tensor, grad: torch.Tensor,
                            xbias: torch.Tensor | None = None,
                            route: Plan | None = None) -> tuple:
    """The backward kernel on CUDA tensors: (dx, dweight, dbias, dxbias) as
    ``group_norm_act_backward_plain`` computes them, from the forward's ``stats``; one
    cooperative launch as ``plan(..., backward=True)`` cuts it (``route``: a whole Plan in
    its place; the kernel computes each wave's slices from its rows, blocks and waves, as
    ``wave_slices`` does). A launch the card refuses raises."""
    global backward_launches
    if not x.is_cuda:
        raise ValueError("group_norm_act_backward needs CUDA tensors")
    dx = _output(x, weight, bias, grad, groups, xbias)
    if stats.shape != (x.shape[0] * groups, 2) or stats.dtype != torch.float32 \
            or stats.device != x.device:
        raise ValueError(f"bad statistics: {tuple(stats.shape)} {stats.dtype} on "
                         f"{stats.device}")
    x, grad, stats = x.contiguous(), grad.contiguous(), stats.contiguous()
    weight, bias = weight.contiguous(), bias.contiguous()
    if xbias is not None:
        xbias = xbias.contiguous()
    dev = x.get_device()
    N, C, span = x.shape[0], x.shape[1], math.prod(x.shape[2:])
    sms, fns = _device_functions(dev)
    p = route or plan(x.shape, groups, x.dtype, sms, backward=True)
    slots = _slots(x.shape, groups, p)
    partials = torch.empty((slots, 4), dtype=torch.float64, device=x.device)
    ab = torch.empty((N * groups, 2), dtype=torch.float64, device=x.device)
    params = torch.empty((3 if xbias is not None else 2, C), dtype=torch.float32,
                         device=x.device)
    vec = _vec16(span, x, grad, dx)
    stream = torch._C._cuda_getCurrentRawStream(dev)
    name = BACKWARD[x.dtype]
    with launch_device(x.device):
        status = fns[name](
            x.data_ptr(), None if xbias is None else xbias.data_ptr(), weight.data_ptr(),
            bias.data_ptr(), stats.data_ptr(), grad.data_ptr(), dx.data_ptr(),
            params[0].data_ptr(), params[1].data_ptr(),
            None if xbias is None else params[2].data_ptr(), partials.data_ptr(),
            ab.data_ptr(), barrier_counter(x.device, stream).data_ptr(), N, C, groups, span,
            p.blocks, p.waves, p.held, slots, vec, stream)
    check_status(name, status)
    backward_launches += 1
    if x.numel() == 0:
        params.zero_()
    return dx, params[0], params[1], params[2] if xbias is not None else None


def _launch_backward(x, weight, bias, groups, stats, grad, xbias):
    """The backward kernel (``group_norm_act_backward``) on CUDA tensors."""
    return group_norm_act_backward(x, weight, bias, groups, stats, grad, xbias)


class _GroupNormAct(torch.autograd.Function):
    """K4 under autograd: the kernel forward, which also writes each row's mean and rstd,
    and the backward kernel from those; the residual's gradient is the output's."""

    @staticmethod
    def forward(ctx, x, weight, bias, res, groups, xbias):
        out, stats = _launch(x, weight, bias, groups, res, xbias, stats=True)
        ctx.groups = groups
        ctx.save_for_backward(x, weight, bias, xbias, stats)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, weight, bias, xbias, stats = ctx.saved_tensors
        needs = ctx.needs_input_grad
        dx = dw = db = dxb = None
        if any(needs[:3]) or needs[5]:
            dx, dw, db, dxb = _launch_backward(x, weight, bias, ctx.groups, stats, grad,
                                               xbias)
        return (dx if needs[0] else None, dw if needs[1] else None,
                db if needs[2] else None, grad if needs[3] else None, None,
                dxb if needs[5] else None)


def group_norm_act_kernel(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                          groups: int, res: torch.Tensor | None = None,
                          xbias: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel on CUDA tensors: launched directly, or through ``_GroupNormAct`` when
    autograd records (grad mode on and an input requiring grad)."""
    if needs_autograd(x, weight, bias, res, xbias):
        return _GroupNormAct.apply(x, weight, bias, res, groups, xbias)
    return _launch(x, weight, bias, groups, res, xbias)


def group_norm_act(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int,
                   res: torch.Tensor | None = None, impl: str = "auto",
                   xbias: torch.Tensor | None = None) -> torch.Tensor:
    """leaky_relu(group_norm(x [+ xbias]), 0.2) (+ res) for NCHW or NCDHW f32 or bf16;
    the kernel for CUDA tensors, the plain version otherwise (see build.py)."""
    if use_kernel(impl, x):
        return group_norm_act_kernel(x, weight, bias, groups, res, xbias)
    return group_norm_act_plain(x, weight, bias, groups, res, xbias)


def gn_apply_residual(x: torch.Tensor, res: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor, groups: int, impl: str = "auto") -> torch.Tensor:
    """The resblock tail, leaky_relu(group_norm(x), 0.2) + res: ``group_norm_act``'s
    residual case."""
    return group_norm_act(x, weight, bias, groups, res, impl)

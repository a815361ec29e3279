"""K3's backward on the CPU (``ops/cuda/refiner.py``): the closed-form plain backward that
the backward kernel computes, over what the forward kernel keeps.

The backward kernel (csrc/idepthmap_refiner.cu ``refiner_bwd_kernel``) runs only on the
card (tests/test_torch_cuda.py, chip_smoke.py phases 3b, 12 (a) and 13), held there
against its plain version in closed form, ``idepthmap_refiner_backward_plain``, fed with
the tensors the forward kernel kept (the output, each GroupNorm layer's raw conv output,
each GroupNorm's statistics). Here that plain version is fed by the forward kernel's plain
version (``idepthmap_refiner_saved_plain``) and held against:

- plain autograd through ``idepthmap_refiner_plain``: every gradient (guidance, idepth,
  each refiner parameter) within 1e-5 of max|autograd|, the same arithmetic summed in
  another order and with the GroupNorm statistics from one f64 pass where
  ``F.group_norm`` takes its own;
- ``jax.vjp`` of the JAX ``models/refiners.py`` ``idepthmap_refiner`` at "highest"
  precision, the weights carried over by the port's converter: within 1e-4 of max|JAX|
  (the forwards differ by their summation orders, 2e-5 of max, and seven layers of the
  backward carry that on);
- its 1xTF32 form (each conv operand rounded to TF32 as the 1xTF32 kernel rounds it)
  against plain autograd through the TF32-rounding plain version within 1e-3 of max
  (phase 13's bar), and off the exact gradient by more than 1e-5. The two forwards part
  by their roundings (f64 statistics against ``F.group_norm``'s f32 ones, each then
  carried through a TF32 rounding of the next conv's operands), and where a GroupNorm
  value lies within that of LeakyReLU's kink they take two branches (a slope of 1
  against 0.2): each backward is then the gradient of its own forward, and a weight
  gradient of a 60-pixel map moves by a few percent. So the test holds the direct gap
  where no branch flips, and at every shape the two legs (chip_smoke.py ``chain_legs``'
  form): the closed form against autograd through its own forward (``saved_forward``),
  and the two forwards' outputs, within 1e-3 each, every flip at |z| below 1e-3;
- its bf16 form (the refiner as the bf16 kernel rounds it, its gradients f32 but the
  guidance's) against ``jax.vjp`` of ``models/s2d.py`` ``idepthmap_refiner_s2d`` at bf16
  (the function the JAX ``_fused_bwd`` differentiates), on each of BF16_DRAWS draws a
  shape. At these sizes two bf16 gradients of the refiner part by discrete effects: a
  GroupNorm value next to LeakyReLU's kink, or an output next to ReLU's, takes the other
  branch in the other forward, and a weight gradient of 60-96 pixels moves by another
  amount on every draw. JAX's own bf16 VJP lies 0.2-24% from its f32 VJP (``jax_refiner``)
  by leaf and draw, in relative L2 (``leaf_gaps``: |a - r|_2 / |r|_2; a leaf's max
  element swings further, to 49% of its max). So no fixed fraction bounds them on every
  draw, and each leaf is held to JAX's own bf16 error on that draw: its bf16 VJP's relative
  L2 distance from its f32 VJP, at least BF16_FLOOR (1.5 bf16 roundings). The closed form
  lies within BF16_SPREAD_BAR times that of JAX's bf16 VJP, plain autograd at bf16 within
  BF16_PLAIN_BAR times. Over draws 0-19 at each shape (read on the CPU) the closed form
  reached 2.26 times JAX's error at 8 x 12 and 3.01 at 6 x 10, plain autograd 1.75 and
  3.67. The bar fails two planted faults on every draw: conv_final's weight gradient
  scaled by 1.1 (the tightest leaf: JAX's bf16 error there at most 1.1%), and the sign of
  the leaf where JAX's bf16 error is widest flipped, each at least 8.19 times JAX's gap
  over those draws. A 10% error in that widest leaf is
  inside the bar, as it is inside JAX's own bf16 error there. The sharp bf16 check stays the
  leg: the closed form against autograd through its own bf16 forward (``saved_forward``)
  within BF16_LEG_BAR of max, where autograd rounds to bf16 each gradient that crosses a
  bf16 value and the closed form keeps it f32 (0.007-0.022 over seventeen draws). The bf16
  form must also lie farther than 1e-3 from the f32 gradient: it differentiates the bf16
  forward.

The closed form is the plain versions of the backward's two launches composed: its
sequential part (``idepthmap_refiner_sequential_plain``: the input gradients, each conv's
output gradient kept, the GroupNorms' (d gamma, d beta)) and its weight-gradient pass
(``idepthmap_refiner_wgrad_plain`` over the kept maps). At each variant (f32, 1xTF32, bf16)
the composition is held to the closed form written as one reverse loop, each layer's input
and weight gradients together (``single_loop``), within 1e-6 of max.

N = 2, 35 guidance channels at 8 x 12 and 6 x 10, refiner 4's fan-in-scale weights, inputs
made from a seed with numpy.
"""

import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from multi_view_stereonet_tpu.checkpoint import torchscript as jax_torchscript
from multi_view_stereonet_tpu.models.refiners import idepthmap_refiner as jax_refiner
from multi_view_stereonet_tpu.models.s2d import idepthmap_refiner_s2d
from multi_view_stereonet_tpu_torch.checkpoint import convert, random_state_dict
from multi_view_stereonet_tpu_torch.models import IDepthmapRefiner
from multi_view_stereonet_tpu_torch.ops.cuda import closed_form as closed_form_module
from multi_view_stereonet_tpu_torch.ops.cuda import gn_apply
from multi_view_stereonet_tpu_torch.ops.cuda import refiner as refiner_op

AUTOGRAD_BAR = 1e-5
JAX_BAR = 1e-4
TF32_BAR = 1e-3
# The bf16 gradients against jax.vjp at bf16, leaf by leaf on each draw in relative L2:
# the closed form within BF16_SPREAD_BAR, plain autograd within BF16_PLAIN_BAR times JAX's
# own bf16-to-f32 gap, at least BF16_FLOOR.
BF16_SPREAD_BAR = 4.0
BF16_PLAIN_BAR = 5.0
BF16_FLOOR = 3e-3
BF16_DRAWS = tuple(range(6, 11))
BF16_LEG_BAR = 5e-2
SPLIT_BAR = 1e-6
SHAPES = [(8, 12), (6, 10)]
NAME = "refiner4"


def jax_refiner_params(sd):
    """Refiner NAME's JAX params from a state dict in the reference's names, as the JAX
    converter (``checkpoint/torchscript.py`` ``convert_reference_state_dict``) builds each
    refiner's, with its helpers; only this refiner's arrays are placed on the device."""
    sd = {k: v.numpy() for k, v in sd.items() if k.startswith(NAME + ".")}
    params = {"conv0": jax_torchscript._conv(sd, f"{NAME}.conv0"),
              "gn0": jax_torchscript._gn(sd, f"{NAME}.bn0"),
              "conv_final": jax_torchscript._conv(sd, f"{NAME}.conv_final")}
    params.update({f"res{i}": jax_torchscript._res(sd, f"{NAME}.res{i}")
                   for i in range(refiner_op.NUM_RES)})
    return jax.tree.map(lambda a: jnp.asarray(np.asarray(a)), params)


def case(h, w, seed):
    """The refiner, its JAX params, guidance (N, 35, h, w), idepth and the output's
    gradient (N, h, w), as torch tensors."""
    sd = random_state_dict(seed)
    jparams = jax_refiner_params(sd)
    refiner = IDepthmapRefiner(35)
    refiner.load_state_dict({k[len(NAME) + 1:]: v for k, v in sd.items()
                             if k.startswith(NAME + ".")})
    rng = np.random.default_rng(seed + h)
    guidance = rng.uniform(-1, 1, size=(2, 35, h, w)).astype(np.float32)
    idepth = rng.uniform(0, 20, size=(2, h, w)).astype(np.float32)
    cot = rng.normal(size=(2, h, w)).astype(np.float32)
    return refiner, jparams, [torch.from_numpy(a) for a in (guidance, idepth, cot)]


def names(refiner):
    return ["guidance", "idepth", *(n for n, _ in refiner.named_parameters())]


def closed_form(refiner, guidance, idepth, cot, needs=(True,) * 3, tf32=False,
                dtype=torch.float32):
    guidance = guidance.to(dtype)
    out, raw, stats = refiner_op.idepthmap_refiner_saved_plain(refiner, guidance, idepth, tf32)
    return refiner_op.idepthmap_refiner_backward_plain(refiner, guidance, idepth, out, raw,
                                                       stats, cot, needs, tf32)


def flat(grads):
    d_guidance, d_idepth, d_params = grads
    return [d_guidance, d_idepth, *d_params]


def autograd(plain, refiner, guidance, idepth, cot, dtype=torch.float32):
    leaves = [guidance.to(dtype).requires_grad_(), idepth.clone().requires_grad_()]
    out = plain(refiner, *leaves)
    return torch.autograd.grad(out, leaves + list(refiner.parameters()), cot)


def worst(got, ref):
    """The largest gradient error of max|ref|, and whose."""
    errs = [((a.float() - r.float()).abs().max() / r.float().abs().max()).item()
            for a, r in zip(got, ref)]
    return max(errs), int(np.argmax(errs))


def assert_within(got, ref, bar, names):
    for name, a, r in zip(names, got, ref):
        assert a.shape == r.shape, name
    err, at = worst(got, ref)
    assert err <= bar, (names[at], err)


@functools.lru_cache(maxsize=None)
def _jitted_vjp(fn, dtype):
    """The jitted VJP of ``fn`` at ``dtype``, one a function and dtype, so that every draw
    and test of a shape reuses one compile."""
    def run(p, g, i, c):
        _, vjp = jax.vjp(lambda p, g, i: fn(p, g, i, compute_dtype=dtype), p, g, i)
        return vjp(c)
    return jax.jit(run)


def jax_vjp(fn, jparams, refiner, guidance, idepth, cot, dtype=jnp.float32):
    """``jax.vjp`` of ``fn`` (NHWC guidance at ``dtype``, f32 idepth), the weights'
    gradients carried to the port's layout by its converter; f32 tensors in ``names``'
    order."""
    g = jnp.asarray(guidance.numpy().transpose(0, 2, 3, 1)).astype(dtype)
    with jax.default_matmul_precision("highest"):
        d_params, d_g, d_i = _jitted_vjp(fn, dtype)(jparams, g, jnp.asarray(idepth.numpy()),
                                                    jnp.asarray(cot.numpy()))
    sd = {}
    convert._conv(sd, "conv0", d_params["conv0"])
    convert._gn(sd, "bn0", d_params["gn0"])
    for i in range(refiner_op.NUM_RES):
        convert._res(sd, f"res{i}", d_params[f"res{i}"])
    convert._conv(sd, "conv_final", d_params["conv_final"])
    d_g = np.asarray(d_g.astype(jnp.float32)).transpose(0, 3, 1, 2)
    return [torch.from_numpy(np.array(a, dtype=np.float32)) for a in
            (d_g, d_i, *(sd[n] for n, _ in refiner.named_parameters()))]


@pytest.mark.parametrize("h,w", SHAPES)
def test_closed_form_matches_autograd(h, w):
    """Every gradient of the closed form against plain autograd through
    ``idepthmap_refiner_plain``; the saved forward's output equals the plain module's."""
    refiner, _, (guidance, idepth, cot) = case(h, w, seed=3)
    ref = autograd(refiner_op.idepthmap_refiner_plain, refiner, guidance, idepth, cot)
    with torch.no_grad():
        out, raw, stats = refiner_op.idepthmap_refiner_saved_plain(refiner, guidance, idepth)
        plain = refiner_op.idepthmap_refiner_plain(refiner, guidance, idepth)
    assert raw.shape == (7, 2, h, w, 32) and stats.shape == (7, 2, 2, 4)
    assert (out - plain).abs().max() <= AUTOGRAD_BAR * plain.abs().max()
    got = flat(closed_form(refiner, guidance, idepth, cot))
    assert_within(got, ref, AUTOGRAD_BAR, names(refiner))


@pytest.mark.parametrize("h,w", SHAPES)
def test_closed_form_matches_jax_vjp(h, w):
    """Every gradient against ``jax.vjp`` of the JAX ``idepthmap_refiner`` at "highest",
    the weights' gradients carried to the port's layout by its converter."""
    refiner, jparams, (guidance, idepth, cot) = case(h, w, seed=4)
    ref = jax_vjp(jax_refiner, jparams, refiner, guidance, idepth, cot)
    got = flat(closed_form(refiner, guidance, idepth, cot))
    assert_within(got, ref, JAX_BAR, names(refiner))


def gn_values(monkeypatch, plain, refiner, guidance, idepth):
    """The GroupNorm values z (before LeakyReLU) of ``plain``'s forward, layer by layer,
    NHWC, seen by a spy on the plain GroupNorm."""
    zs = []
    group_norm_act_plain = gn_apply.group_norm_act_plain

    def spy(x, weight, bias, groups, res=None, xbias=None):
        zs.append(F.group_norm(x.float(), groups, weight, bias, gn_apply.EPS).permute(0, 2, 3, 1))
        return group_norm_act_plain(x, weight, bias, groups, res, xbias)
    monkeypatch.setattr(gn_apply, "group_norm_act_plain", spy)
    with torch.no_grad():
        plain(refiner, guidance, idepth)
    monkeypatch.setattr(gn_apply, "group_norm_act_plain", group_norm_act_plain)
    return zs


@pytest.mark.parametrize("h,w", SHAPES)
def test_tf32_closed_form_matches_autograd_through_the_rounding_plain(h, w, monkeypatch):
    """The 1xTF32 form against plain autograd through ``idepthmap_refiner_tf32_plain``
    (whose forward rounds the same operands; its backward's gradient operands are not
    rounded): within 1e-3 of max where the two forwards take the same LeakyReLU branches,
    and in two legs at every shape; off the exact gradient by more than the f32 bar."""
    refiner, _, (guidance, idepth, cot) = case(h, w, seed=5)
    got = flat(closed_form(refiner, guidance, idepth, cot, tf32=True))
    leaves = [guidance.clone().requires_grad_(), idepth.clone().requires_grad_(),
              *(p.detach().clone().requires_grad_() for p in refiner.parameters())]
    out = refiner_op.saved_forward(leaves[2:], leaves[0], leaves[1],
                                   refiner_op._dilations(refiner), tf32=True)[0]
    assert_within(got, torch.autograd.grad(out, leaves, cot), TF32_BAR, names(refiner))
    plain = refiner_op.idepthmap_refiner_tf32_plain(refiner, guidance, idepth)
    assert (out - plain).abs().max() <= TF32_BAR * plain.abs().max()
    with torch.no_grad():
        _, raw, stats = refiner_op.idepthmap_refiner_saved_plain(refiner, guidance, idepth,
                                                                 True)
    weights = [p.detach() for p in refiner.parameters()]
    flips = []
    for k, zp in enumerate(gn_values(monkeypatch, refiner_op.idepthmap_refiner_tf32_plain,
                                     refiner, guidance, idepth)):
        z = closed_form_module._gn_forward(raw[k], stats[k], *weights[4 * k + 2:4 * k + 4])[1]
        flips += z[(z > 0) != (zp > 0)].tolist()
    assert all(abs(z) < TF32_BAR for z in flips), flips
    ref = autograd(refiner_op.idepthmap_refiner_tf32_plain, refiner, guidance, idepth, cot)
    if not flips:
        assert_within(got, ref, TF32_BAR, names(refiner))
    exact = flat(closed_form(refiner, guidance, idepth, cot))
    assert worst(got, exact)[0] > AUTOGRAD_BAR


def leaf_gaps(got, ref):
    """Each leaf's relative L2 distance, |got - ref|_2 / |ref|_2."""
    return np.array([((a.float() - r.float()).norm() / r.float().norm()).item()
                     for a, r in zip(got, ref)])


@pytest.mark.parametrize("seed", BF16_DRAWS)
@pytest.mark.parametrize("h,w", SHAPES)
def test_bf16_closed_form_matches_jax_vjp_at_bf16(h, w, seed):
    """On a draw, the bf16 form against ``jax.vjp`` of ``idepthmap_refiner_s2d`` at bf16,
    leaf by leaf in relative L2: the closed form within BF16_SPREAD_BAR and plain autograd
    at bf16 within BF16_PLAIN_BAR times JAX's own bf16 VJP's distance from its f32 VJP
    (at least BF16_FLOOR); the closed form with conv_final's weight gradient 10% off, or
    with the sign of the leaf where JAX's gap is widest flipped, outside the bar; the
    guidance's gradient at bf16, the rest f32. On the first draw, the closed form against
    autograd through its own bf16 forward within BF16_LEG_BAR, and off the f32 gradient by
    more than 1e-3."""
    refiner, jparams, (guidance, idepth, cot) = case(h, w, seed=seed)
    leaves = names(refiner)
    got = flat(closed_form(refiner, guidance, idepth, cot, dtype=torch.bfloat16))
    assert got[0].dtype == torch.bfloat16
    assert all(g.dtype == torch.float32 for g in got[1:])
    ref = jax_vjp(idepthmap_refiner_s2d, jparams, refiner, guidance, idepth, cot, jnp.bfloat16)
    jax_gap = np.maximum(leaf_gaps(ref, jax_vjp(jax_refiner, jparams, refiner, guidance,
                                                idepth, cot)), BF16_FLOOR)
    plain = autograd(refiner_op.idepthmap_refiner_plain, refiner, guidance, idepth, cot,
                     torch.bfloat16)
    ratio = leaf_gaps(plain, ref) / jax_gap
    assert ratio.max() <= BF16_PLAIN_BAR, (leaves[int(np.argmax(ratio))], ratio.max())
    ratio = leaf_gaps(got, ref) / jax_gap
    assert ratio.max() <= BF16_SPREAD_BAR, (leaves[int(np.argmax(ratio))], ratio.max())
    widest = int(np.argmax(jax_gap))
    for at, scale in ((leaves.index("conv_final.weight"), 1.1), (widest, -1.0)):
        faulty = [t * scale if k == at else t for k, t in enumerate(got)]
        assert (leaf_gaps(faulty, ref) / jax_gap)[at] > BF16_SPREAD_BAR, (leaves[at], scale)
    if seed != BF16_DRAWS[0]:
        return
    leg = [guidance.to(torch.bfloat16).requires_grad_(), idepth.clone().requires_grad_(),
           *(p.detach().clone().requires_grad_() for p in refiner.parameters())]
    out = refiner_op.saved_forward(leg[2:], leg[0], leg[1], refiner_op._dilations(refiner))[0]
    assert_within(got, torch.autograd.grad(out, leg, cot), BF16_LEG_BAR, leaves)
    exact = flat(closed_form(refiner, guidance, idepth, cot))
    assert worst(got, exact)[0] > 1e-3


def test_closed_form_leaves_out_what_is_not_asked_for():
    """``needs`` (guidance, idepth, the parameters): None for what it leaves out, the rest
    unchanged."""
    refiner, _, (guidance, idepth, cot) = case(6, 10, seed=7)
    full = closed_form(refiner, guidance, idepth, cot)
    for needs in ((False, True, True), (True, False, False)):
        part = closed_form(refiner, guidance, idepth, cot, needs)
        for got, want, need in zip(part, full, needs):
            if not need:
                assert got is None
            elif isinstance(want, tuple):
                assert all(torch.equal(a, b) for a, b in zip(got, want))
            else:
                assert torch.equal(got, want)


def single_loop(refiner, guidance, idepth, out, raw, stats, grad, tf32=False):
    """The closed form as one reverse loop: for each layer its GroupNorm's backward, then
    its conv's input and weight gradients together; (d guidance, d idepth, (d parameter
    for each of ``named_parameters``))."""
    cf = closed_form_module
    dtype = guidance.dtype
    rnd = cf._operand_round(dtype, tf32)
    weights = [p.detach().float() for p in refiner.parameters()]
    dilations = refiner_op._dilations(refiner)
    with torch.no_grad():
        x = torch.cat([guidance.float().permute(0, 2, 3, 1),
                       cf._round_to(dtype, idepth.float())[..., None]], -1)
        hs = []
        for k in range(refiner_op.NUM_GN):
            branch = cf._leaky(cf._gn_forward(raw[k], stats[k], *weights[4 * k + 2:4 * k + 4])[1],
                               dtype)
            hs.append(branch if k == 0 else cf._round_to(dtype, hs[-1] + branch))
        gout = grad.float() * (out > 0)
        dparams = [None] * len(weights)
        dh, dparams[-2] = cf._conv_grads(hs[-1], weights[-2], gout[..., None], rnd)
        dparams[-1] = gout.sum().reshape(1)
        for k in range(refiner_op.NUM_GN - 1, -1, -1):
            w, _, gamma, beta = weights[4 * k:4 * k + 4]
            xhat, z = cf._gn_forward(raw[k], stats[k], gamma, beta)
            dt, dgamma, dbeta = cf._gn_backward(dh, z, xhat, stats[k], gamma, dtype)
            d = 1 if k == 0 else dilations[k - 1]
            gx, dw = cf._conv_grads(x if k == 0 else hs[k - 1], w, dt, rnd, d)
            dparams[4 * k:4 * k + 4] = dw, dt.sum((0, 1, 2)), dgamma, dbeta
            if k > 0:
                dh = dh + gx
        cg = guidance.shape[1]
    return (gx[..., :cg].permute(0, 3, 1, 2).to(dtype), gout + gx[..., cg], tuple(dparams))


@pytest.mark.parametrize("variant", ["f32", "tf32", "bf16"])
def test_split_closed_form_matches_the_single_loop(variant):
    """The plain versions of the backward's two launches, composed, against the closed form
    as one reverse loop, within 1e-6 of max at each variant: the sequential part keeps
    what the weight-gradient pass reads (each conv's output gradient, the GroupNorms'
    (d gamma, d beta)), and the pass gives every parameter's gradient from it."""
    refiner, _, (guidance, idepth, cot) = case(6, 10, seed=3)
    tf32, dtype = variant == "tf32", torch.bfloat16 if variant == "bf16" else torch.float32
    guidance = guidance.to(dtype)
    out, raw, stats = refiner_op.idepthmap_refiner_saved_plain(refiner, guidance, idepth, tf32)
    seq = refiner_op.idepthmap_refiner_sequential_plain(refiner, guidance, idepth, out, raw,
                                                        stats, cot, tf32)
    assert seq[2].shape == (7, 2, 6, 10, 32) and seq[3].shape == (2, 6, 10)
    assert seq[4].shape == (7, 2, 32)
    got = flat(refiner_op.idepthmap_refiner_backward_plain(refiner, guidance, idepth, out, raw,
                                                           stats, cot, tf32=tf32))
    ref = flat(single_loop(refiner, guidance, idepth, out, raw, stats, cot, tf32))
    assert got[0].dtype == dtype
    assert_within(got, ref, SPLIT_BAR, names(refiner))

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
  (the function the JAX ``_fused_bwd`` differentiates). The port's plain autograd at bf16
  is held to BF16_JAX_BAR, 0.11 of max|JAX|. The closed form is held to that bar or to
  BF16_PLAIN_RATIO times plain autograd's own gap at the same inputs, whichever is larger.
  At these sizes two bf16 gradients of the refiner part by discrete effects: a GroupNorm
  value next to LeakyReLU's kink, or an output next to ReLU's, takes the other branch in
  the other forward, and a weight gradient of 60-96 pixels moves by a tenth of its max.
  Over seventeen draws of these inputs at both shapes (read on the CPU) the closed form
  lies 0.06-0.93 of max from JAX's bf16 VJP, plain autograd 0.06-0.93, and JAX's own bf16
  VJP 0.08-1.54 from its f32 VJP. The closed form's gap over plain autograd's has median
  1.0 and reaches 2.21. Rounding the closed form's T_l or its gradients where plain
  autograd rounds them does not bring it nearer (0.191 and 0.099 at 8 x 12, 0.132 and
  0.121 at 6 x 10, against 0.100 and 0.121). So the sharp bf16 check is the leg: the
  closed form against autograd through its own bf16 forward (``saved_forward``) within
  BF16_LEG_BAR, where autograd rounds to bf16 each gradient that crosses a bf16 value and
  the closed form keeps it f32 (0.007-0.022 over those draws). The bf16 form must also lie
  farther than 1e-3 from the f32 gradient: it differentiates the bf16 forward.

N = 2, 35 guidance channels at 8 x 12 and 6 x 10, refiner 4's fan-in-scale weights, inputs
made from a seed with numpy.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from multi_view_stereonet_tpu.checkpoint import convert_reference_state_dict
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
# The bf16 gradients against jax.vjp at bf16, of max|JAX|: plain autograd within
# BF16_JAX_BAR; the closed form within that or BF16_PLAIN_RATIO times plain autograd's gap.
BF16_JAX_BAR = 0.11
BF16_PLAIN_RATIO = 2.25
BF16_LEG_BAR = 5e-2
SHAPES = [(8, 12), (6, 10)]
NAME = "refiner4"


def case(h, w, seed):
    """The refiner, its JAX params, guidance (N, 35, h, w), idepth and the output's
    gradient (N, h, w), as torch tensors."""
    sd = random_state_dict(seed)
    jparams = convert_reference_state_dict({k: v.numpy() for k, v in sd.items()})[NAME]
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


def jax_vjp(fn, jparams, refiner, guidance, idepth, cot, dtype=jnp.float32):
    """``jax.vjp`` of ``fn`` (NHWC guidance at ``dtype``, f32 idepth), the weights'
    gradients carried to the port's layout by its converter; f32 tensors in ``names``'
    order."""
    def run(p, g, i, c):
        _, vjp = jax.vjp(lambda p, g, i: fn(p, g, i, compute_dtype=dtype), p, g, i)
        return vjp(c)
    g = jnp.asarray(guidance.numpy().transpose(0, 2, 3, 1)).astype(dtype)
    with jax.default_matmul_precision("highest"):
        d_params, d_g, d_i = jax.jit(run)(jparams, g, jnp.asarray(idepth.numpy()),
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


@pytest.mark.parametrize("h,w", SHAPES)
def test_bf16_closed_form_matches_jax_vjp_at_bf16(h, w):
    """The bf16 form against ``jax.vjp`` of ``idepthmap_refiner_s2d`` at bf16: plain
    autograd at bf16 within BF16_JAX_BAR of max|JAX|, the closed form within that or
    BF16_PLAIN_RATIO times plain autograd's gap; the closed form against autograd through
    its own bf16 forward within BF16_LEG_BAR; the guidance's gradient at bf16, the rest
    f32; off the f32 gradient by more than 1e-3."""
    refiner, jparams, (guidance, idepth, cot) = case(h, w, seed=6)
    got = flat(closed_form(refiner, guidance, idepth, cot, dtype=torch.bfloat16))
    assert got[0].dtype == torch.bfloat16
    assert all(g.dtype == torch.float32 for g in got[1:])
    ref = jax_vjp(idepthmap_refiner_s2d, jparams, refiner, guidance, idepth, cot, jnp.bfloat16)
    plain = autograd(refiner_op.idepthmap_refiner_plain, refiner, guidance, idepth, cot,
                     torch.bfloat16)
    assert_within(plain, ref, BF16_JAX_BAR, names(refiner))
    bar = max(BF16_JAX_BAR, BF16_PLAIN_RATIO * worst(plain, ref)[0])
    assert_within(got, ref, bar, names(refiner))
    leaves = [guidance.to(torch.bfloat16).requires_grad_(), idepth.clone().requires_grad_(),
              *(p.detach().clone().requires_grad_() for p in refiner.parameters())]
    out = refiner_op.saved_forward(leaves[2:], leaves[0], leaves[1],
                                   refiner_op._dilations(refiner))[0]
    assert_within(got, torch.autograd.grad(out, leaves, cot), BF16_LEG_BAR, names(refiner))
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

"""K2's backward on the CPU (``ops/cuda/incremental_chain.py``): the closed-form plain
backward that the backward kernel computes, over what the forward kernel keeps.

The backward kernel (csrc/incremental_chain.cu ``chain_bwd_kernel``) runs only on the
card (tests/test_torch_cuda.py, chip_smoke.py phases 3b, 12 (a) and 13), held there
against its plain version in closed form, ``incremental_chain_backward_plain``, fed with
the tensors the forward kernel kept (the chain, each step's raw h and raw r, its
GroupNorms' statistics). Here that plain version is fed by the forward kernel's plain
version (``incremental_chain_saved_plain``) and held against:

- plain autograd through ``incremental_chain_plain``: every gradient (feats0, image_rest,
  H_inc, each refiner parameter) within 1e-5 of max|autograd|, the same arithmetic
  summed in another order and with the GroupNorm statistics from one f64 pass where
  ``F.group_norm`` takes its own;
- ``jax.vjp`` of the JAX ``_incremental_scan`` (``models/mvsnet.py:218-234``), which the
  JAX ``_chain_bwd`` takes, with the weights carried over by the port's converter: each
  gradient within 1e-4 of max|JAX| (the forwards themselves differ by their summation
  orders, 2e-5 of max at this size, tests/test_torch_kernels_plain.py, and eleven steps
  of the warp's transpose carry that on);
- its 1xTF32 form (each conv operand rounded to TF32 as the 1xTF32 kernel rounds it)
  against plain autograd through the TF32-rounding loop within 1e-3 of max (phase 13's
  bar);
- its bf16 form (the chain as the bf16 kernel rounds it, its gradients f32) against
  ``jax.vjp`` of ``_incremental_scan`` at bf16 within BF16_JAX_BAR of max, a bar that
  also holds the port's plain autograd at bf16: the JAX scan at bf16 warps at bf16 and
  rounds every gradient to bf16, where the kernel warps in f32 and keeps its gradients
  f32, so the two are bf16 gradients of the same scan only to within bf16's noise (the
  bf16 recipe trains alike under either: scripts/k2_bf16_convergence_torch.py, ROADMAP
  Queue 3); and against autograd through its own rounded forward
  within 2e-2 (chip_smoke.py ``CHAIN_LEGS``), off the f32 gradient by more than 1e-3.

The closed form is the plain versions of the backward's two launches composed: its
sequential part (``incremental_chain_sequential_plain``: the input gradients, each conv's
output gradient and each step's carry gradient kept, the GroupNorms' (d gamma, d beta)) and
its weight-gradient pass (``incremental_chain_wgrad_plain`` over the kept maps). At each
variant (f32, 1xTF32, bf16) the composition is held to the closed form written as one
reverse loop, each step's input and weight gradients together (``single_loop``), within
1e-6 of max.

N = 2, D = 4, 6 x 8 x 32 (and D = 6 at 5 x 7), with homographies from random poses and
fan-in-scale weights, inputs made from a seed with numpy (``tests/test_torch_kernels_plain``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multi_view_stereonet_tpu.models.mvsnet import _incremental_scan
from multi_view_stereonet_tpu_torch.checkpoint import convert
from multi_view_stereonet_tpu_torch.ops.cuda import incremental_chain as chain

from tests.test_torch_kernels_plain import chain_inputs, refiner_pair

AUTOGRAD_BAR = 1e-5
JAX_BAR = 1e-4
# The bf16 gradients against jax.vjp at bf16, of max|JAX|: read on the CPU 0.045-0.136 for
# the closed form and 0.034-0.084 for the port's plain autograd at bf16, at four shapes.
BF16_JAX_BAR = 0.15
SPLIT_BAR = 1e-6


def case(N, D, h, w, seed):
    """The refiner pair, the inputs as torch tensors and the output's gradient."""
    refiner, jparams = refiner_pair(seed)
    feats0, image_rest, H_inc = chain_inputs(N, D, h, w, seed)
    cot = np.random.default_rng(seed + 100).normal(size=(N, D, h, w, 32)).astype(np.float32)
    tensors = [torch.from_numpy(np.array(a)) for a in (feats0, image_rest, H_inc, cot)]
    return refiner, jparams, tensors


def closed_form(refiner, feats0, image_rest, H_inc, cot, needs=(True,) * 4, tf32=False,
                dtype=torch.float32):
    with torch.no_grad():
        out, raw, stats = chain.incremental_chain_saved_plain(
            refiner, feats0.to(dtype), image_rest.to(dtype), H_inc, tf32)
        return chain.incremental_chain_backward_plain(
            refiner, feats0.to(dtype), image_rest.to(dtype), H_inc, out, raw, stats,
            cot.to(dtype), needs, tf32)


def flat(grads):
    d_feats0, d_image, d_H, d_params = grads
    return [d_feats0, d_image, d_H, *d_params]


def assert_within(got, ref, bar, names):
    for name, a, r in zip(names, got, ref):
        assert a.shape == r.shape, name
        scale = r.abs().max().item()
        err = (a.float() - r.float()).abs().max().item()
        assert err <= bar * scale, (name, err / scale)


def names(refiner):
    return ["feats0", "image_rest", "H_inc", *(n for n, _ in refiner.named_parameters())]


def jax_vjp(jparams, refiner, feats0, image_rest, H_inc, cot, dtype=jnp.float32):
    """``jax.vjp`` of ``_incremental_scan`` with hypothesis 0 concatenated (the JAX
    ``_chain_bwd``'s function), feats0, image_rest and the output's gradient at ``dtype``,
    the weights' gradients carried to the port's layout by its converter; f32 tensors."""
    def xla_chain(p, f0, imgs, H):
        return jnp.concatenate([f0[:, None], _incremental_scan(p, f0, imgs, H)], axis=1)
    _, vjp = jax.vjp(xla_chain, jparams, *(jnp.asarray(t.numpy()).astype(dtype)
                                           for t in (feats0, image_rest)),
                     jnp.asarray(H_inc.numpy()))
    d_params, d_feats0, d_image, d_H = vjp(jnp.asarray(cot.numpy()).astype(dtype))
    sd = {}
    convert._conv(sd, "conv0", d_params["conv0"])
    convert._gn(sd, "bn0", d_params["gn0"])
    convert._res(sd, "res0", d_params["res0"])
    convert._conv(sd, "conv_final", d_params["conv_final"])
    return [torch.from_numpy(np.array(a.astype(jnp.float32))) for a in
            (d_feats0, d_image, d_H, *(sd[n] for n, _ in refiner.named_parameters()))]


@pytest.mark.parametrize("N,D,h,w", [(2, 4, 6, 8), (1, 6, 5, 7)])
def test_closed_form_matches_autograd(N, D, h, w):
    """Every gradient of the closed form against plain autograd through
    ``incremental_chain_plain``; the saved forward's chain equals the plain loop's."""
    refiner, _, (feats0, image_rest, H_inc, cot) = case(N, D, h, w, seed=N + D)
    leaves = [t.clone().requires_grad_() for t in (feats0, image_rest, H_inc)]
    params = list(refiner.parameters())
    out = chain.incremental_chain_plain(refiner, *leaves)
    ref = torch.autograd.grad(out, leaves + params, cot)
    with torch.no_grad():
        saved_out, raw, stats = chain.incremental_chain_saved_plain(refiner, feats0,
                                                                   image_rest, H_inc)
    assert raw.shape == (N, D - 1, 2, h, w, 32) and stats.shape == (N, D - 1, 2, 2, 4)
    assert (saved_out - out).abs().max() <= AUTOGRAD_BAR * out.abs().max()
    got = flat(closed_form(refiner, feats0, image_rest, H_inc, cot))
    assert_within(got, ref, AUTOGRAD_BAR, names(refiner))


def test_closed_form_matches_jax_vjp():
    """Every gradient, H_inc's included, against ``jax.vjp`` of ``_incremental_scan`` with
    hypothesis 0 concatenated (the JAX ``_chain_bwd``'s function), the weights' gradients
    carried to the port's layout by its converter."""
    refiner, jparams, (feats0, image_rest, H_inc, cot) = case(2, 4, 6, 8, seed=3)
    ref = jax_vjp(jparams, refiner, feats0, image_rest, H_inc, cot)
    got = flat(closed_form(refiner, feats0, image_rest, H_inc, cot))
    assert_within(got, ref, JAX_BAR, names(refiner))


def test_closed_form_leaves_out_what_is_not_asked_for():
    """``needs`` (feats0, image_rest, H_inc, the parameters): None for what it leaves out,
    the rest unchanged."""
    refiner, _, (feats0, image_rest, H_inc, cot) = case(1, 3, 4, 5, seed=9)
    full = closed_form(refiner, feats0, image_rest, H_inc, cot)
    part = closed_form(refiner, feats0, image_rest, H_inc, cot, (True, False, False, False))
    assert part[1] is None and part[2] is None and part[3] is None
    assert torch.equal(part[0], full[0])


def autograd(plain, refiner, feats0, image_rest, H_inc, cot, dtype=torch.float32):
    leaves = [feats0.to(dtype).requires_grad_(), image_rest.to(dtype).requires_grad_(),
              H_inc.clone().requires_grad_()]
    out = plain(refiner, *leaves)
    return torch.autograd.grad(out, leaves + list(refiner.parameters()), cot.to(dtype))


def test_tf32_closed_form_matches_autograd_through_the_rounding_loop():
    """The 1xTF32 form (each conv operand rounded to TF32, as the 1xTF32 kernel's convs
    round them) against plain autograd through ``incremental_chain_tf32_plain`` (whose
    forward rounds the same operands; its backward's gradient operands are not rounded):
    within 1e-3 of max, the bar of the 1xTF32 kernels (chip_smoke.py phase 13), and off
    the exact gradient by more than the f32 bar."""
    refiner, _, (feats0, image_rest, H_inc, cot) = case(2, 4, 6, 8, seed=5)
    got = flat(closed_form(refiner, feats0, image_rest, H_inc, cot, tf32=True))
    ref = autograd(chain.incremental_chain_tf32_plain, refiner, feats0, image_rest, H_inc, cot)
    assert_within(got, ref, 1e-3, names(refiner))
    exact = flat(closed_form(refiner, feats0, image_rest, H_inc, cot))
    assert max((a - r).abs().max() / r.abs().max() for a, r in zip(got, exact)) > AUTOGRAD_BAR


def test_bf16_closed_form_matches_jax_vjp_at_bf16():
    """The bf16 form (the chain as the bf16 kernel rounds it, its convs' operands bf16,
    its gradients f32) against ``jax.vjp`` of the scan at bf16, every gradient within
    BF16_JAX_BAR of max|JAX|, as the port's plain autograd at bf16 is; each gradient at
    its input's dtype."""
    refiner, jparams, (feats0, image_rest, H_inc, cot) = case(2, 4, 6, 8, seed=5)
    got = flat(closed_form(refiner, feats0, image_rest, H_inc, cot, dtype=torch.bfloat16))
    assert got[0].dtype == got[1].dtype == torch.bfloat16
    assert all(g.dtype == torch.float32 for g in got[2:])
    ref = jax_vjp(jparams, refiner, feats0, image_rest, H_inc, cot, jnp.bfloat16)
    assert_within(got, ref, BF16_JAX_BAR, names(refiner))
    plain = autograd(chain.incremental_chain_plain, refiner, feats0, image_rest, H_inc, cot,
                     torch.bfloat16)
    assert_within(plain, ref, BF16_JAX_BAR, names(refiner))


def test_bf16_closed_form_keeps_its_rounding_points():
    """The bf16 form against plain autograd through the same rounded forward
    (``saved_forward`` at bf16: the one rounds each conv's gradient operand to bf16, as the
    kernel's mma does, the other each conv's result) within 2e-2 of max, and off the f32
    gradient of the same inputs by more than 1e-3: it differentiates the bf16 forward."""
    refiner, _, (feats0, image_rest, H_inc, cot) = case(2, 4, 6, 8, seed=5)
    bf16 = torch.bfloat16
    got = closed_form(refiner, feats0, image_rest, H_inc, cot, (True, False, False, True),
                      dtype=bf16)
    leaves = [feats0.to(bf16).requires_grad_(),
              *(t.detach().clone().requires_grad_() for t in chain._weights(refiner))]
    out = chain.saved_forward(leaves[1:], leaves[0], image_rest.to(bf16), H_inc)[0]
    ref = torch.autograd.grad(out, leaves, cot.to(bf16))
    by_layout = dict(zip(names(refiner)[3:], got[3]))
    grads = [got[0], *(by_layout[name] for name, _, _ in chain.LAYOUT)]
    assert_within(grads, ref, 2e-2, ["feats0", *(name for name, _, _ in chain.LAYOUT)])
    exact = closed_form(refiner, feats0, image_rest, H_inc, cot, (True, False, False, True))
    assert max(((a.float() - r).abs().max() / r.abs().max()).item()
               for a, r in zip([got[0], *got[3]], [exact[0], *exact[3]])) > 1e-3


def test_homography_grid_backward_matches_autograd():
    """H's gradient through the grid in closed form against autograd through
    ``homography_grid``."""
    from multi_view_stereonet_tpu_torch.ops.warp import homography_grid
    rng = np.random.default_rng(4)
    H = torch.from_numpy((np.eye(3) + 0.05 * rng.normal(size=(3, 3, 3))).astype(np.float32))
    dgrid = torch.from_numpy(rng.normal(size=(3, 5, 7, 2)).astype(np.float32))
    leaf = H.clone().requires_grad_()
    ref, = torch.autograd.grad(homography_grid(leaf, 5, 7), leaf, dgrid)
    got = chain.homography_grid_backward(H, dgrid)
    assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()


def single_loop(refiner, feats0, image_rest, H_inc, out, raw, stats, grad, tf32=False):
    """The closed form as one reverse loop: for each step its convs' input and weight
    gradients together; (d feats0, d image_rest, d H_inc, (d parameter for each of
    ``named_parameters``))."""
    from multi_view_stereonet_tpu_torch.ops import homography_grid
    from multi_view_stereonet_tpu_torch.ops.cuda import closed_form as cf
    from multi_view_stereonet_tpu_torch.ops.cuda.warp import (
        grid_sample_backward_plain, grid_sample_plain)
    dtype = feats0.dtype
    rnd = cf._operand_round(dtype, tf32)
    weights = [t.detach().float() for t in chain._weights(refiner)]
    w0, b0, g0, be0, wr, br, gr, ber, wf, bf = weights
    h, w = feats0.shape[1], feats0.shape[2]
    grad = grad.float()
    dparams = [torch.zeros_like(t) for t in weights]
    dimage = torch.zeros(image_rest.shape)
    dH = torch.zeros(H_inc.shape)
    carry_grad = grad[:, -1]
    with torch.no_grad():
        for d in range(H_inc.shape[1] - 1, -1, -1):
            carry = out[:, d].float()
            grid = homography_grid(H_inc[:, d].float(), h, w)
            warped = cf._round_to(dtype, grid_sample_plain(carry, grid, zero_invalid=True)[0])
            x0 = torch.cat([cf._round_to(dtype, image_rest[:, d].float()), warped], -1)
            xh0, z0 = cf._gn_forward(raw[:, d, 0], stats[:, d, 0], g0, be0)
            xhr, zr = cf._gn_forward(raw[:, d, 1], stats[:, d, 1], gr, ber)
            hn = cf._leaky(z0, dtype)
            res = cf._round_to(dtype, hn + cf._leaky(zr, dtype))
            gres, dw = cf._conv_grads(res, wf, carry_grad, rnd)
            dparams[8] += dw
            dparams[9] += carry_grad.sum((0, 1, 2))
            dr, dg, db = cf._gn_backward(gres, zr, xhr, stats[:, d, 1], gr, dtype)
            dparams[6] += dg
            dparams[7] += db
            ghn, dw = cf._conv_grads(hn, wr, dr, rnd)
            ghn = ghn + gres
            dparams[4] += dw
            dparams[5] += dr.sum((0, 1, 2))
            da, dg, db = cf._gn_backward(ghn, z0, xh0, stats[:, d, 0], g0, dtype)
            dparams[2] += dg
            dparams[3] += db
            gx0, dw = cf._conv_grads(x0, w0, da, rnd)
            dparams[0] += dw
            dparams[1] += da.sum((0, 1, 2))
            dimage[:, d] = gx0[..., :3]
            dcarry, dgrid = grid_sample_backward_plain(carry, grid, carry_grad + gx0[..., 3:],
                                                       True, (True, True))
            dH[:, d] = chain.homography_grid_backward(H_inc[:, d], dgrid)
            carry_grad = grad[:, d] + dcarry
    by_name = dict(zip((name for name, _, _ in chain.LAYOUT), dparams))
    return (carry_grad.to(dtype), dimage.to(image_rest.dtype), dH,
            tuple(by_name[n] for n, _ in refiner.named_parameters()))


@pytest.mark.parametrize("variant", ["f32", "tf32", "bf16"])
def test_split_closed_form_matches_the_single_loop(variant):
    """The plain versions of the backward's two launches, composed, against the closed form
    as one reverse loop, within 1e-6 of max at each variant: the sequential part keeps
    what the weight-gradient pass reads (each step's conv0 and resblock output gradients,
    the gradient of every step's output, the GroupNorms' (d gamma, d beta)), and the pass
    gives every parameter's gradient from it."""
    refiner, _, (feats0, image_rest, H_inc, cot) = case(1, 3, 4, 5, seed=9)
    tf32, dtype = variant == "tf32", torch.bfloat16 if variant == "bf16" else torch.float32
    feats0, image_rest, cot = feats0.to(dtype), image_rest.to(dtype), cot.to(dtype)
    with torch.no_grad():
        out, raw, stats = chain.incremental_chain_saved_plain(refiner, feats0, image_rest,
                                                              H_inc, tf32)
    seq = chain.incremental_chain_sequential_plain(refiner, feats0, image_rest, H_inc, out,
                                                   raw, stats, cot, tf32=tf32)
    assert seq[3].shape == (1, 2, 2, 4, 5, 32) and seq[4].shape == (1, 3, 4, 5, 32)
    assert seq[5].shape == (4, 32)
    got = flat(chain.incremental_chain_backward_plain(refiner, feats0, image_rest, H_inc, out,
                                                      raw, stats, cot, tf32=tf32))
    ref = flat(single_loop(refiner, feats0, image_rest, H_inc, out, raw, stats, cot, tf32))
    assert got[0].dtype == dtype
    assert_within(got, ref, SPLIT_BAR, names(refiner))

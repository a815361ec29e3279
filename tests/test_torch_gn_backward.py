"""K4's backward and its route rule on the CPU (``ops/cuda/gn_apply.py``).

The backward kernel (csrc/gn_apply.cu ``gn_bwd_kernel``) runs only on the card
(tests/test_torch_cuda.py, chip_smoke.py phases 3b and 12 (a)), held there against its
plain version in closed form, ``group_norm_act_backward_plain``, which is held here
against plain autograd through ``group_norm_act_plain`` and against ``jax.vjp`` of the
JAX layers' ``leaky_relu(group_norm(x + b)) + res`` (``models/layers.py:97-126``), NHWC
transposed. Inputs are made from a seed with numpy. Bars:

- f32: every gradient within 1e-5 of max|reference| (autograd's, JAX's);
- bf16, against autograd at bf16: dx within one bf16 ulp of autograd's dx at each
  element (both round the same f32 value, computed in another order), plus 2^-21 of
  max|dx| where an element nearly cancels (rstd (g gamma - a - x_hat b) with terms of
  order one: the two f32 values differ by a few 2^-24 of those terms, more than a bf16
  ulp of a tiny result); the parameter gradients and d xbias within 1e-5 of
  max|autograd|;
- the statistics the forward writes (``group_stats_plain``) within 1e-6 relative of an
  f64 numpy computation (their f32 rounding);
- the route rule (``plan``) at every serving and recipe shape for an H100's 132 SMs, and
  the backward's wave schedule (``wave_slices``): every value in one block's slice of one
  wave, every row whole in one wave, each wave within the hold budget.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multi_view_stereonet_tpu.models.layers import group_norm as jax_group_norm
from multi_view_stereonet_tpu.models.layers import leaky_relu as jax_leaky_relu
from multi_view_stereonet_tpu_torch.ops.cuda import gn_apply

BAR = 1e-5
F32_FLOOR = 2.0 ** -21  # times max|dx|: the f32 rounding of an element that nearly cancels
BF16 = torch.bfloat16
H100_SMS = 132


def inputs(shape, seed, dtype=torch.float32):
    """x (off-centre, as a conv output is), res, gamma, beta, xbias and the output's
    gradient, as torch tensors (x, res and the gradient at ``dtype``)."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * 2 + 0.5).astype(np.float32)
    res = rng.normal(size=shape).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, size=shape[1]).astype(np.float32)
    beta = (rng.normal(size=shape[1]) * 0.1).astype(np.float32)
    xbias = (rng.normal(size=shape[1]) * 0.3).astype(np.float32)
    grad = rng.normal(size=shape).astype(np.float32)
    t = [torch.from_numpy(a) for a in (x, res, gamma, beta, xbias, grad)]
    return (t[0].to(dtype), t[1].to(dtype), t[2], t[3], t[4], t[5].to(dtype))


def autograd_reference(x, res, gamma, beta, xbias, grad):
    """Plain autograd through ``group_norm_act_plain``: (dx, dgamma, dbeta, dxbias, dres)
    (dxbias, dres None where not given)."""
    leaves = [t.detach().clone().requires_grad_() if t is not None else None
              for t in (x, gamma, beta, xbias, res)]
    out = gn_apply.group_norm_act_plain(leaves[0], leaves[1], leaves[2], 4, leaves[4],
                                        leaves[3])
    wanted = [t for t in leaves if t is not None]
    grads = iter(torch.autograd.grad(out, wanted, grad))
    return [next(grads) if t is not None else None for t in leaves]


CASES = [((2, 32, 4, 6), True, True), ((2, 32, 4, 6), False, False),
         ((2, 32, 3, 4, 5), False, True), ((2, 32, 3, 4, 5), True, False)]


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("shape,residual,with_xbias", CASES)
def test_backward_plain_matches_autograd(shape, residual, with_xbias, dtype):
    x, res, gamma, beta, xbias, grad = inputs(shape, seed=len(shape) + residual, dtype=dtype)
    res = res if residual else None
    xbias = xbias if with_xbias else None
    stats = gn_apply.group_stats_plain(x, 4, xbias)
    got = gn_apply.group_norm_act_backward_plain(x, gamma, beta, 4, stats, grad, xbias)
    ref = autograd_reference(x, res, gamma, beta, xbias, grad)
    assert (got[3] is None) == (xbias is None)
    if residual:
        assert torch.equal(ref[4], grad)  # what the Function returns for res
    assert got[0].dtype == dtype and all(g.dtype == torch.float32 for g in got[1:]
                                         if g is not None)
    for i, (g, r) in enumerate(zip(got, ref[:4])):
        if r is None:
            continue
        g, r = g.float(), r.float()
        if i == 0 and dtype == BF16:
            ulp = torch.exp2(torch.floor(torch.log2(r.abs().clamp_min(1e-30))) - 7)
            floor = F32_FLOOR * r.abs().max()
            assert torch.all((g - r).abs() <= ulp + floor), (g - r).abs().max()
        else:
            assert (g - r).abs().max() <= BAR * r.abs().max(), (i, (g - r).abs().max())


@pytest.mark.parametrize("shape,residual,with_xbias", CASES)
def test_backward_plain_matches_jax_vjp(shape, residual, with_xbias):
    """The closed form against ``jax.vjp`` of the JAX layers, channels last, f32."""
    x, res, gamma, beta, xbias, grad = inputs(shape, seed=10 + len(shape) + residual)
    xbias = xbias if with_xbias else torch.zeros_like(xbias)
    stats = gn_apply.group_stats_plain(x, 4, xbias)
    got = gn_apply.group_norm_act_backward_plain(x, gamma, beta, 4, stats, grad, xbias)

    def last(t):
        return jnp.asarray(np.moveaxis(t.numpy(), 1, -1))

    def f(x, scale, bias, xb, r):
        y = jax_leaky_relu(jax_group_norm({"scale": scale, "bias": bias}, x + xb, groups=4))
        return y + r if residual else y
    _, vjp = jax.vjp(f, last(x), jnp.asarray(gamma.numpy()), jnp.asarray(beta.numpy()),
                     jnp.asarray(xbias.numpy()), last(res))
    ref = vjp(last(grad))
    ref = [np.moveaxis(np.asarray(ref[0]), -1, 1)] + [np.asarray(r) for r in ref[1:4]]
    for g, r in zip(got, ref):
        assert np.abs(g.numpy() - r).max() <= BAR * np.abs(r).max()
    if residual:
        np.testing.assert_array_equal(np.moveaxis(np.asarray(vjp(last(grad))[4]), -1, 1),
                                      grad.numpy())


@pytest.mark.parametrize("shape", [(2, 32, 4, 6), (3, 16, 2, 3, 5)])
@pytest.mark.parametrize("with_xbias", [True, False])
def test_forward_statistics_match_f64(shape, with_xbias):
    x, _, _, _, xbias, _ = inputs(shape, seed=3)
    xbias = xbias if with_xbias else None
    got = gn_apply.group_stats_plain(x, 4, xbias).numpy()
    v = x.numpy().astype(np.float32)
    if xbias is not None:
        v = v + xbias.numpy().reshape((1, -1) + (1,) * (x.ndim - 2))
    rows = v.astype(np.float64).reshape(shape[0] * 4, -1)
    mean = rows.mean(1)
    rstd = 1.0 / np.sqrt(rows.var(1) + gn_apply.EPS)
    assert got.shape == (shape[0] * 4, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got[:, 0], mean, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got[:, 1], rstd, rtol=1e-6)


# Every K4 shape of the serving forward (B = 1, V = 1 and 5), of the recipe's training
# step (B = 8, 480x640: extractor N = B + B*V, refiners 2-0, the filter N = B*V) and of
# the convergence recipe (96x128, B = 4), with the residual or without, and for 132 SMs
# the forward's chunks a (sample, group) row and the backward's (route, blocks, waves,
# values a block holds) at f32 and at bf16.
ROUTES = [
    ((2, 32, 30, 40), True, 3, ("resident", 19, 1, 4048), ("resident", 10, 1, 7680)),
    ((1, 32, 120, 160), True, 38, ("resident", 132, 1, 4656), ("resident", 75, 1, 8192)),
    ((1, 32, 240, 320), True, 132, ("resident", 132, 1, 18624), ("resident", 132, 1, 18624)),
    ((1, 32, 480, 640), True, 132, ("partial", 132, 1, 28672), ("partial", 132, 1, 57344)),
    ((1, 32, 480, 640), False, 132, ("partial", 132, 1, 28672), ("partial", 132, 1, 57344)),
    ((1, 32, 12, 30, 40), False, 29, ("resident", 113, 1, 4080), ("resident", 57, 1, 8088)),
    ((5, 32, 12, 30, 40), False, 27, ("resident", 132, 1, 17456), ("resident", 132, 1, 17456)),
    ((16, 32, 30, 40), True, 3, ("resident", 132, 1, 4656), ("resident", 75, 1, 8192)),
    ((8, 32, 120, 160), True, 17, ("partial", 132, 1, 28672), ("resident", 132, 1, 37240)),
    ((8, 32, 240, 320), True, 17, ("waves", 132, 4, 28672), ("partial", 132, 1, 57344)),
    ((8, 32, 480, 640), True, 17, ("waves", 132, 16, 28672), ("partial", 132, 1, 57344)),
    ((8, 32, 480, 640), False, 17, ("waves", 132, 16, 28672), ("partial", 132, 1, 57344)),
    ((8, 32, 12, 30, 40), False, 17, ("resident", 132, 1, 27928), ("resident", 132, 1, 27928)),
    ((8, 32, 6, 8), True, 1, ("resident", 3, 1, 4096), ("resident", 2, 1, 6144)),
    ((4, 32, 96, 128), True, 24, ("resident", 132, 1, 11920), ("resident", 132, 1, 11920)),
    ((4, 32, 96, 128), False, 24, ("resident", 132, 1, 11920), ("resident", 132, 1, 11920)),
    ((4, 32, 12, 6, 8), False, 2, ("resident", 18, 1, 4096), ("resident", 9, 1, 8192)),
]


@pytest.mark.parametrize("shape,residual,chunks,f32_plan,bf16_plan", ROUTES)
def test_route_rule_at_the_serving_and_recipe_shapes(shape, residual, chunks, f32_plan,
                                                     bf16_plan):
    """``plan`` from shape, dtype and SM count alone: the forward's chunks (``chunking``
    over BLOCKS_PER_SM blocks an SM) at either dtype, and the backward's route, blocks,
    waves and held values, with the geometry it keeps (at most one block an SM, ``held``
    a multiple of 8 with x's and dy's within HOLD_BYTES; "resident": one wave of slices
    covering x with none empty, each held whole; "partial": one wave over every SM, held
    in part; "waves": more)."""
    E = int(np.prod(shape))
    for dtype, want in ((torch.float32, f32_plan), (BF16, bf16_plan)):
        p = gn_apply.plan(shape, 4, dtype, H100_SMS)
        assert (p.route, p.slice, p.blocks) == ("chunked", *gn_apply.chunking(
            shape[0] * 4, E // (shape[0] * 4), gn_apply.BLOCKS_PER_SM * H100_SMS))
        assert p.blocks == chunks
        p = gn_apply.plan(shape, 4, dtype, H100_SMS, backward=True)
        assert (p.route, p.blocks, p.waves, p.held) == want
        size = torch.empty((), dtype=dtype).element_size() * 2
        assert p.slice % 8 == 0 and p.held % 8 == 0 and p.held * size <= gn_apply.HOLD_BYTES
        assert 1 <= p.blocks <= H100_SMS and p.held <= p.slice
        assert p.slice == max(q for _, _, q in gn_apply.wave_slices(shape, 4, p))
        if p.route == "resident":
            assert p.waves == 1 and p.held == p.slice
            assert (p.blocks - 1) * p.slice < E <= p.blocks * p.slice <= E + 8 * p.blocks
        else:
            assert p.blocks == H100_SMS and (p.waves == 1) == (p.route == "partial")


# The wave schedule: the recipe's large calls as planned, and small calls cut into many
# waves by a smaller hold budget, with no share of L2 and with one.
SCHEDULES = [((8, 32, 480, 640), torch.float32, {}), ((8, 32, 480, 640), BF16, {}),
             ((8, 32, 240, 320), torch.float32, {}), ((8, 32, 120, 160), torch.float32, {}),
             ((8, 32, 30, 40), torch.float32, {"hold": 2048, "reread": 0, "partial": 0}),
             ((8, 32, 30, 40), torch.float32,
              {"hold": 4096, "reread": 64 * 1024, "partial": 0}),
             ((3, 16, 45, 47), torch.float32, {"hold": 512, "reread": 0, "partial": 0})]


@pytest.mark.parametrize("shape,dtype,budget", SCHEDULES)
def test_wave_schedule_covers_every_value_once(shape, dtype, budget):
    """Every value of x lies in exactly one block's slice of exactly one wave, every
    (sample, group) row lies whole in one wave, a wave holds at most ``hold`` bytes of x
    and dy a block (its held part) and goes beyond that by at most ``reread`` over the card
    in waves (unless one row alone does), by at most ``partial`` in one wave at f32; every span piece has its own partial slot among
    ``_slots``'s, as csrc/gn_apply.cu indexes them (sg * maxb + b - first block of the
    span)."""
    groups = shape[1] // 8
    p = gn_apply.plan(shape, groups, dtype, H100_SMS, backward=True, **budget)
    hold = budget.get("hold", gn_apply.HOLD_BYTES)
    reread = budget.get("reread", gn_apply.REREAD_BYTES)
    size = torch.empty((), dtype=dtype).element_size() * 2
    E, S = int(np.prod(shape)), int(np.prod(shape[2:]))
    L = E // (shape[0] * groups)
    parts = []  # (lo, hi) of every non-empty slice
    slots = gn_apply._slots(shape, groups, p)
    used = set()
    waves = gn_apply.wave_slices(shape, groups, p)
    assert len(waves) == p.waves and waves[0][0] == 0 and waves[-1][1] == E
    for (e0, e1, q), nxt in zip(waves, waves[1:] + [(E, E, 0)]):
        assert e0 % L == 0 and e1 % L == 0 and e1 > e0 and nxt[0] == e1  # whole rows
        assert q % 8 == 0 and p.blocks * q >= e1 - e0
        assert p.held * size <= hold
        twice = max(0, q - p.held) * size * p.blocks  # bytes the wave reads twice
        if p.route == "waves":
            assert twice <= reread or e1 - e0 == L
        elif dtype == torch.float32:  # bf16 keeps one wave, whatever it reads twice
            assert twice <= budget.get("partial", gn_apply.WAVES_BYTES)
        maxb = -(-S // min(w[2] for w in waves)) + 1
        for b in range(p.blocks):
            lo, hi = e0 + b * q, min(e1, e0 + (b + 1) * q)
            if lo >= hi:
                continue
            parts.append((lo, hi))
            for sg in range(lo // S, (hi - 1) // S + 1):
                first = (sg * S - e0) // q
                assert first <= b <= ((sg + 1) * S - 1 - e0) // q and b - first < maxb
                slot = sg * maxb + b - first
                assert slot < slots and slot not in used
                used.add(slot)
    parts.sort()
    assert parts[0][0] == 0 and parts[-1][1] == E
    assert all(a[1] == b[0] for a, b in zip(parts, parts[1:]))  # no gap, no overlap
    if budget:
        assert p.waves > 3

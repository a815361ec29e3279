"""K1's backward on the CPU (``ops/cuda/warp.py``): the border clip's gradient and the
closed-form plain backward that the backward kernel computes.

The backward kernel (csrc/warp.cu ``grid_sample_bwd_kernel``) runs only on the card
(tests/test_torch_cuda.py, chip_smoke.py phases 3b and 12 (a)), held there against its
plain version in closed form, ``grid_sample_backward_plain``, which is held here against
plain autograd through ``grid_sample_plain`` and against ``jax.vjp`` of the JAX
``grid_sample`` (``multi_view_stereonet_tpu/ops/warp.py:31-79``, with invalid samples
zeroed by ``jnp.where`` as ``homography_warp_auto(zero_invalid=True)`` does). Inputs are
made from a seed with numpy. Bars: every gradient within 1e-5 of max|reference|
(autograd's, JAX's): the same products summed in another order.

A coordinate exactly on the clamp border (ix = 0 or W - 1, iy = 0 or H - 1) is a tie of
``jnp.clip``, whose maximum and minimum each pass half the gradient there; ``torch.clamp``
passes all of it. H and W are powers of two, so that the normalized coordinates of those
points are exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multi_view_stereonet_tpu.ops import warp as jwarp
from multi_view_stereonet_tpu_torch.ops.cuda import warp

BAR = 1e-5


def tie_points(H, W):
    """Normalized (x, y) points whose unnormalized coordinate is exactly 0 or the last
    pixel in x, in y or in both, with the other coordinate inside."""
    lo_x, hi_x = -1 + 1 / W, 1 - 1 / W
    lo_y, hi_y = -1 + 1 / H, 1 - 1 / H
    return np.array([[lo_x, 0.1], [0.3, lo_y], [lo_x, lo_y], [hi_x, -0.2], [0.05, hi_y],
                     [hi_x, hi_y], [lo_x, hi_y]], np.float32)


def inputs(B, H, W, C, out_shape, seed, ties=True, nan=False):
    """image (B, H, W, C), grid (B, *out_shape, 2) with a tenth of its points outside
    [-1, 1], the tie points at the start where ``ties``, NaN coordinates where ``nan``,
    and the output's gradient."""
    rng = np.random.default_rng(seed)
    image = rng.normal(size=(B, H, W, C)).astype(np.float32)
    grid = rng.uniform(-1.15, 1.15, size=(B, int(np.prod(out_shape)), 2)).astype(np.float32)
    if ties:
        t = tie_points(H, W)
        grid[:, :len(t)] = t
    if nan:
        grid[0, -1] = [np.nan, 0.2]
        grid[-1, -2] = [0.4, np.nan]
        grid[-1, -3] = [np.nan, 1.5]
    grid = grid.reshape(B, *out_shape, 2)
    cot = rng.normal(size=(B, *out_shape, C)).astype(np.float32)
    return torch.from_numpy(image), torch.from_numpy(grid), torch.from_numpy(cot)


def autograd_reference(image, grid, cot, zero_invalid):
    leaves = [image.clone().requires_grad_(), grid.clone().requires_grad_()]
    out, _ = warp.grid_sample_plain(*leaves, zero_invalid)
    return torch.autograd.grad(out, leaves, cot)


def jax_reference(image, grid, cot, zero_invalid):
    def f(im, gr):
        out, invalid = jwarp.grid_sample(im, gr)
        return jnp.where(invalid[..., None], 0.0, out) if zero_invalid else out
    _, vjp = jax.vjp(f, jnp.asarray(image.numpy()), jnp.asarray(grid.numpy()))
    return [torch.from_numpy(np.array(g)) for g in vjp(jnp.asarray(cot.numpy()))]


def assert_within(got, ref, bar=BAR):
    for a, r in zip(got, ref):
        assert a.shape == r.shape
        scale = r.abs().max().item()
        assert (a - r).abs().max().item() <= bar * scale, (a - r).abs().max().item() / scale


def test_border_tie_grid_gradient_matches_jax():
    """At ix = 0 and iy = 0 (and at W - 1, H - 1) the port's grid gradient through
    ``grid_sample_plain`` is ``jax.vjp``'s: half the gradient where ``torch.clamp`` gave
    all of it (twice JAX's at ix = 0 or iy = 0). The image's gradient equals JAX's too."""
    image, grid, cot = inputs(1, 8, 16, 2, (7,), seed=0)
    got = autograd_reference(image, grid, cot, False)
    ref = jax_reference(image, grid, cot, False)
    assert_within(got, ref)
    # The points themselves: not zero, so the halving is seen.
    assert (ref[1][0, :3].abs() > 1e-3).any()
    np.testing.assert_allclose(got[1][0, :3].numpy(), ref[1][0, :3].numpy(), rtol=1e-5,
                               atol=1e-6)


def test_clip_keeps_the_clamp_values_bit_for_bit():
    """The forward's clip (``_clip``: a maximum, then a minimum) gives ``torch.clamp``'s
    values, NaN, infinities and the bounds themselves included; so the forward is
    unchanged bit for bit."""
    rng = np.random.default_rng(1)
    u = rng.uniform(-3, 12, size=4096).astype(np.float32)
    u[:8] = [0.0, 9.0, -0.0, np.nan, np.inf, -np.inf, 1e-30, 9.000001]
    u = torch.from_numpy(u)
    torch.testing.assert_close(warp._clip(u, 9.0), torch.clamp(u, 0.0, 9.0), rtol=0, atol=0,
                               equal_nan=True)
    image, grid, _ = inputs(2, 8, 16, 3, (5, 6), seed=2)
    out, invalid = warp.grid_sample_plain(image, grid, True)
    ref, ref_invalid = jwarp.grid_sample(jnp.asarray(image.numpy()), jnp.asarray(grid.numpy()))
    ref = np.where(np.asarray(ref_invalid)[..., None], 0.0, np.asarray(ref))
    np.testing.assert_array_equal(invalid.numpy(), np.asarray(ref_invalid))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("zero_invalid", [False, True])
@pytest.mark.parametrize("B,H,W,C,out_shape", [(2, 8, 16, 1, (5, 7)), (1, 16, 8, 3, (9, 4)),
                                               (3, 4, 32, 3, (2, 6, 5))])
def test_closed_form_matches_autograd_and_jax(B, H, W, C, out_shape, zero_invalid):
    """``grid_sample_backward_plain`` against plain autograd through ``grid_sample_plain``
    and against ``jax.vjp``, with points outside [-1, 1] and on the ties; C = 1 and 3;
    ``zero_invalid`` both ways; and each gradient alone when only one is asked for."""
    image, grid, cot = inputs(B, H, W, C, out_shape, seed=B * H + C)
    got = warp.grid_sample_backward_plain(image, grid, cot, zero_invalid)
    assert_within(got, autograd_reference(image, grid, cot, zero_invalid))
    assert_within(got, jax_reference(image, grid, cot, zero_invalid))
    d_image, none = warp.grid_sample_backward_plain(image, grid, cot, zero_invalid,
                                                    (True, False))
    none2, d_grid = warp.grid_sample_backward_plain(image, grid, cot, zero_invalid,
                                                    (False, True))
    assert none is None and none2 is None
    assert torch.equal(d_image, got[0]) and torch.equal(d_grid, got[1])


@pytest.mark.parametrize("zero_invalid", [False, True])
def test_closed_form_carries_nan_coordinates_as_autograd(zero_invalid):
    """A NaN coordinate: NaN in the same entries of both gradients as plain autograd's
    (the taps of pixel (0, 0) and its neighbours, where the forward's index clamp takes
    them), everything else within the bar; a bf16 output gradient is read as its f32
    value."""
    image, grid, cot = inputs(2, 8, 16, 3, (4, 5), seed=7, nan=True)
    got = warp.grid_sample_backward_plain(image, grid, cot, zero_invalid)
    ref = autograd_reference(image, grid, cot, zero_invalid)
    for a, r in zip(got, ref):
        assert torch.equal(torch.isnan(a), torch.isnan(r))
        assert torch.isnan(r).any()
        keep = ~torch.isnan(r)
        assert (a[keep] - r[keep]).abs().max() <= BAR * r[keep].abs().max()
    half = cot.to(torch.bfloat16)
    got16 = warp.grid_sample_backward_plain(image, grid, half, zero_invalid)
    want16 = warp.grid_sample_backward_plain(image, grid, half.float(), zero_invalid)
    for a, r in zip(got16, want16):
        assert torch.equal(torch.isnan(a), torch.isnan(r))
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(r))

"""The port's CUDA kernels against their plain versions, on an NVIDIA card.

Every test here is marked ``cuda`` and skips without a card. The file
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Bars, with TF32 off: the grid sample within 1e-5 abs and equal invalid
masks (bit-equal at the losses' shapes, NaN where the plain version has NaN; its
backward within 1e-4 of max|plain autograd|); the incremental chain (at the serving shapes and at N = 8, one step,
a 4x5 and a 48x64 map, a pose with many invalid samples) and the idepthmap
refiner within atol 2e-5 * max|plain|, rtol 2e-4, also after its weights are written
(its packed weights followed); the GroupNorm kernel within 1e-5 * max(1, max|plain|) at
every serving and recipe shape (at bf16 within phase 11's rounding bar), and its backward
kernel within 1e-4 of max|plain| of its plain version and of plain autograd (1e-2 at
bf16; the output's gradient 0 within a rounding of LeakyReLU's kink), bit-equal over two
calls, a refused launch raising in either; the grid sample's backward kernel within 1e-5,
the chain's within 1e-4 (1e-3 in 1xTF32, 1e-2 at bf16) and the refiner's within 1e-4 (1e-3
in 1xTF32, 2e-2 at bf16) of max|plain| of their closed forms, one backward launch a call;
the whole forward within 0.2% of each level's output range; the multi-view and
the two-view training losses and gradients within docs/PARITY.md:218-232's bar. The u8 dequantize is
bit-equal to the host pipeline for all 256 values. Each kernel's custom op passes
``torch.library.opcheck``, and the serving artifact exported on the card holds all
four and is bit-equal to the live forward. Two processes on the card over gloo give one
process's training step (``tests/_torch_distributed_worker.py``); with two cards, each
kernel launches on its tensors' card while another is current. The streaming runner with
the card named twice (two replicas, a stream and a K3 barrier counter each) is bit-equal
to one replica at the same per-forward batches over the f32 and u8 transports; with two
cards, one replica a card is bit-equal to one card, and a runner on card 1 alone reads
back what card 0 serves while card 0 is current. At bf16: the grid
sample's bf16 output is its f32 output rounded, the GroupNorm kernel is within a
rounding of the GroupNorm value of its plain version, the chain within 5% of max|plain|
(2% of the f32 chain), the refiner within 1% of max|plain|, K3's bf16 pack is never
served to the f32 kernel, and the bf16 forward launches all four. The 1xTF32 variants
(``matmul_precision: high``): the chain within 1e-3 and the refiner within 3e-4 of
max|plain| of their TF32-rounding plain versions, the 3xTF32 kernel unchanged after a
1xTF32 launch, and a forward at "high" launching both.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch
import yaml

from multi_view_stereonet_tpu_torch.checkpoint import random_state_dict
from multi_view_stereonet_tpu_torch.geometry import (
    build_K_pyramid, create_idepth_samples, create_plane_sweep_homographies,
    incremental_homographies, normalize_baseline, project_idepthmap)
from multi_view_stereonet_tpu_torch.models import (
    CostVolumeFilter, FeatureRefiner, IDepthmapRefiner, MultiViewStereoNet,
    MultiViewStereoNetConfig, mvsnet_forward)
from multi_view_stereonet_tpu_torch.ops import build_image_pyramid, homography_grid
from multi_view_stereonet_tpu_torch.ops.cuda import build, gn_apply
from multi_view_stereonet_tpu_torch.ops.cuda import incremental_chain as chain
from multi_view_stereonet_tpu_torch.ops.cuda import refiner as refiner_op
from multi_view_stereonet_tpu_torch.ops.cuda import warp

REFINER_ATOL, REFINER_RTOL = 2e-5, 2e-4
GN_BAR = 1e-5


def counts():
    return (warp.launches, chain.launches, refiner_op.launches, gn_apply.launches)


def backward_counts():
    return (warp.backward_launches, chain.backward_launches, gn_apply.backward_launches)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def scene(n, rows, cols, seed):
    """Intrinsics (n, 4, 4) at rows x cols and unit-baseline right poses."""
    rng = np.random.default_rng(seed)
    K = np.eye(4, dtype=np.float32)
    K[0, 0] = K[1, 1] = 0.9 * cols
    K[0, 2], K[1, 2] = (cols - 1) / 2.0, (rows - 1) / 2.0
    T = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    T[:, 0, 3] = rng.uniform(0.3, 0.5, size=n)
    T[:, 1:3, 3] = rng.uniform(-0.05, 0.05, size=(n, 2))
    T, _ = normalize_baseline(torch.from_numpy(T))
    return torch.from_numpy(np.repeat(K[None], n, 0)), T


# Three channels (the serving path's warps, the kernel's unrolled path) and 32 (its
# loop over a runtime channel count).
@pytest.mark.parametrize("image_shape,grid_shape", [((2, 64, 80, 3), (2, 64, 80, 2)),
                                                    ((3, 30, 40, 3), (3, 12, 30, 40, 2)),
                                                    ((2, 16, 20, 32), (2, 4, 16, 20, 2))])
def test_grid_sample_kernel_matches_plain(dev, image_shape, grid_shape):
    g = torch.Generator().manual_seed(0)
    image = (torch.rand(image_shape, generator=g) * 2 - 1).to(dev)
    grid = (torch.rand(grid_shape, generator=g) * 2.2 - 1.1).to(dev)
    before = warp.launches
    got, inv = warp.grid_sample(image, grid, zero_invalid=True)
    ref, inv_ref = warp.grid_sample(image, grid, zero_invalid=True, impl="plain")
    torch.cuda.synchronize()
    assert warp.launches == before + 1
    assert (got - ref).abs().max().item() <= 1e-5
    assert torch.equal(inv, inv_ref)


# The two-view losses' samples: one channel (idepth maps, occlusion masks) at a
# pyramid level and at full size, three (the reconstruction); image and grid both leaves.
@pytest.mark.parametrize("shape", [(2, 30, 40, 1), (2, 120, 160, 1), (2, 120, 160, 3)])
def test_grid_sample_kernel_at_the_loss_shapes_forward_and_backward(dev, shape):
    """K1 where the losses call it: the grid projected from an idepth map (as
    ``project_idepthmap`` gives it, with samples outside the image), against its plain
    version: the forward bit for bit with equal invalid masks, and the gradients of image
    and grid through ``_GridSample`` within 1e-4 of max|plain autograd|, no launch in
    the backward."""
    from multi_view_stereonet_tpu_torch.geometry import project_idepthmap

    B, H, W, C = shape
    g = torch.Generator().manual_seed(C * H)
    K, T = scene(B, H, W, seed=H)
    idepth = torch.rand(B, H, W, generator=g) * 0.4 + 0.1
    grid = project_idepthmap(K, T, idepth)[0].to(dev).requires_grad_()
    image = (torch.rand(shape, generator=g) * 2 - 1).to(dev).requires_grad_()
    cot = torch.randn(B, H, W, C, generator=g).to(dev)
    grads = {}
    for impl in ("kernel", "plain"):
        before = warp.launches
        out, inv = warp.grid_sample(image, grid, impl=impl)
        assert warp.launches == before + (impl == "kernel")
        grads[impl] = (out.detach(), inv, torch.autograd.grad(out, (image, grid), cot))
        torch.cuda.synchronize()
        assert warp.launches == before + (impl == "kernel")
    (out, inv, got), (ref, inv_ref, want) = grads["kernel"], grads["plain"]
    assert torch.equal(out, ref) and torch.equal(inv, inv_ref)
    assert 0 < inv.float().mean().item() < 1
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()


@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("zero_invalid", [False, True])
def test_grid_sample_kernel_carries_nan_coordinates(dev, C, zero_invalid):
    """A NaN in either coordinate gives NaN in every channel, exactly where the plain
    version (and the JAX gather) does, with the same invalid flags; +-inf clamps to the
    border as there; every other sample is bit-equal."""
    g = torch.Generator().manual_seed(C)
    image = (torch.rand(2, 16, 20, C, generator=g) * 2 - 1).to(dev)
    grid = torch.rand(2, 6, 7, 2, generator=g) * 2.4 - 1.2
    nan, inf = float("nan"), float("inf")
    grid[0, 0, :6] = torch.tensor([[nan, 0.1], [0.2, nan], [nan, nan], [nan, 5.0],
                                   [inf, 0.3], [-inf, -inf]])
    grid[1, 3, 2:4] = torch.tensor([[0.5, -inf], [inf, nan]])
    grid = grid.to(dev)
    got, inv = warp.grid_sample(image, grid, zero_invalid, impl="kernel")
    ref, inv_ref = warp.grid_sample(image, grid, zero_invalid, impl="plain")
    assert torch.equal(inv, inv_ref)
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    assert torch.isnan(ref).any() and torch.isinf(grid).any()
    assert torch.equal(torch.nan_to_num(got, nan=7.0), torch.nan_to_num(ref, nan=7.0))


def loss_like_grid(n, rows, cols, seed, straddle=False):
    """A grid like the two-view losses' (``chip_smoke.py`` ``loss_grid``): a tilted-plane
    idepth map per sample (0.1-0.5 at a unit baseline) projected into the right camera by
    ``project_idepthmap``; a share falls past the left border. ``straddle`` pushes every
    8th sample from column 288 on of every 7th row past the left border as well, so that
    a warp's samples mix clamped ones, summed by their first lane, with unclamped ones
    whose taps land on the same border pixels."""
    K, T = scene(n, rows, cols, seed)
    rng = np.random.default_rng(seed)
    a, b, c = rng.uniform(0, 0.2, size=(3, n, 1, 1)).astype(np.float32)
    y = np.linspace(0, 1, rows, dtype=np.float32)[:, None]
    x = np.linspace(0, 1, cols, dtype=np.float32)[None, :]
    grid = project_idepthmap(K, T, torch.from_numpy(0.1 + a + b * x + c * y))[0]
    if straddle:
        grid[:, 3::7, 288::8, 0] -= 3.0
    return grid


# K1's backward kernel: a small map with ties and NaN, random grids (few clamped samples
# of a warp share their taps), C = 1, 3 and 32 (the runtime channel loop); and loss-like
# grids at C = 1 and 3 (whole warps of clamped samples summed by their first lanes), also
# straddling the border (such sums and single taps at the same pixels), with a tie and NaN.
@pytest.mark.parametrize("image_shape,grid_shape,kind", [
    ((2, 16, 32, 3), (2, 7, 9, 2), "random"), ((2, 30, 40, 1), (2, 30, 40, 2), "random"),
    ((2, 120, 160, 3), (2, 120, 160, 2), "random"), ((1, 8, 8, 32), (1, 5, 6, 2), "random"),
    ((2, 48, 64, 1), (2, 48, 64, 2), "smooth"), ((2, 48, 64, 3), (2, 48, 64, 2), "smooth"),
    ((2, 32, 480, 1), (2, 32, 480, 2), "straddle"),
    ((2, 32, 480, 3), (2, 32, 480, 2), "straddle")])
@pytest.mark.parametrize("zero_invalid", [False, True])
def test_grid_sample_backward_kernel_matches_its_closed_form(dev, image_shape, grid_shape,
                                                             kind, zero_invalid):
    """K1's backward kernel against ``grid_sample_backward_plain`` (closed form) on the same
    inputs, at an f32 and a bf16 output gradient: both gradients within 1e-5 of
    max|plain| (the image's taps summed in a warp and added with atomics, in another
    order), NaN where it has NaN, one backward launch a call and none of the forward; each
    gradient alone when only one is asked for; a refused shape raises."""
    g = torch.Generator().manual_seed(image_shape[1])
    B, H, W, C = image_shape
    image = (torch.rand(image_shape, generator=g) * 2 - 1).to(dev)
    if kind == "random":
        grid = torch.rand(grid_shape, generator=g) * 2.4 - 1.2
    else:
        grid = loss_like_grid(B, H, W, H, straddle=kind == "straddle")
    grid[0, 0, 0] = torch.tensor([-1 + 1 / W, 0.1])  # a tie at ix = 0
    grid[0, 0, 1] = torch.tensor([0.3, 1 - 1 / H])  # and at iy = H - 1
    if grid_shape[1] < 30 or kind != "random":
        grid[-1, -1, -1] = torch.tensor([float("nan"), 0.2])
    grid = grid.to(dev)
    for dtype in (torch.float32, torch.bfloat16):
        cot = torch.randn(grid_shape[:-1] + (C,), generator=g).to(dev, dtype)
        before, bwd_before = counts(), warp.backward_launches
        got = warp.grid_sample_backward(image, grid, cot, zero_invalid)
        torch.cuda.synchronize()
        assert counts() == before and warp.backward_launches == bwd_before + 1
        ref = warp.grid_sample_backward_plain(image, grid, cot, zero_invalid)
        for a, r in zip(got, ref):
            assert a.dtype == torch.float32 and a.shape == r.shape
            assert torch.equal(torch.isnan(a), torch.isnan(r))
            keep = ~torch.isnan(r)
            assert (a[keep] - r[keep]).abs().max() <= 1e-5 * r[keep].abs().max()
        only_image = warp.grid_sample_backward(image, grid, cot, zero_invalid, (True, False))
        only_grid = warp.grid_sample_backward(image, grid, cot, zero_invalid, (False, True))
        assert only_image[1] is None and only_grid[0] is None
        torch.testing.assert_close(only_grid[1], got[1], rtol=0, atol=0, equal_nan=True)
        keep = ~torch.isnan(got[0])
        assert (only_image[0][keep] - got[0][keep]).abs().max() <= 1e-6 * got[0][keep].abs().max()
    with pytest.raises(ValueError):
        warp.grid_sample_backward(image, grid, cot[..., :1].contiguous() if C > 1 else
                                  cot.expand(*cot.shape[:-1], 2), zero_invalid)


def chain_case(n, h, w, d, shift, seed, dev):
    """A seeded FeatureRefiner and chain inputs for n samples of an h x w map, d
    hypotheses. ``shift`` moves every incremental homography's output by that fraction
    of the map (many samples then fall outside it and are zeroed)."""
    prefix = "right_feature_extractor.refiner."
    refiner = FeatureRefiner(32)
    refiner.load_state_dict({k[len(prefix):]: v for k, v in random_state_dict(seed).items()
                             if k.startswith(prefix)})
    refiner = refiner.to(dev).eval()
    K, T = scene(n, h, w, seed=seed)
    samples = create_idepth_samples(T, K, h, w, d)
    H_inc = incremental_homographies(create_plane_sweep_homographies(T, K, samples))
    if shift:
        move = torch.tensor([[1.0, 0.0, shift * w], [0.0, 1.0, shift * h], [0.0, 0.0, 1.0]])
        H_inc = move @ H_inc
    g = torch.Generator().manual_seed(seed)
    feats0 = torch.randn(n, h, w, 32, generator=g).to(dev)
    image_rest = (torch.rand(n, d - 1, h, w, 3, generator=g) * 2 - 1).to(dev)
    return refiner, feats0, image_rest, H_inc.to(dev)


# The serving shapes (N = B*V = 1 and 5, 30x40, D = 12), N = 3 and 8 (two waves of
# 16-block clusters, or one of 8), a single step, a map smaller than the cluster (4x5
# at 64x80 input), a 48x64 map, maps that a block works through in two column tiles
# (20x72) and in two row tiles (160x64), a pose that puts most samples outside the
# map, and the 8-block cluster forced at the serving shape.
@pytest.mark.parametrize("n,h,w,d,shift,cluster", [
    (1, 30, 40, 12, 0.0, 0), (3, 30, 40, 12, 0.0, 0), (5, 30, 40, 12, 0.0, 0),
    (8, 30, 40, 12, 0.0, 0), (2, 30, 40, 2, 0.0, 0), (3, 4, 5, 12, 0.0, 0),
    (2, 48, 64, 12, 0.0, 0), (1, 20, 72, 6, 0.0, 0), (1, 160, 64, 4, 0.0, 0),
    (2, 30, 40, 12, 0.45, 0), (1, 30, 40, 12, 0.0, 8)])
def test_chain_kernel_matches_plain(dev, n, h, w, d, shift, cluster):
    refiner, feats0, image_rest, H_inc = chain_case(n, h, w, d, shift, seed=n + d, dev=dev)
    if shift:
        grid = homography_grid(H_inc[:, 0], h, w)
        assert (grid.abs() > 1).any(-1).float().mean().item() > 0.3
    with torch.inference_mode():
        before = chain.launches
        got = chain.incremental_chain_kernel(refiner, feats0, image_rest, H_inc, cluster)
        ref = chain.incremental_chain(refiner, feats0, image_rest, H_inc, impl="plain")
    torch.cuda.synchronize()
    assert chain.launches == before + 1
    assert got.shape == (n, d, h, w, 32) and torch.isfinite(got).all()
    assert torch.allclose(got, ref, atol=2e-5 * ref.abs().max().item(), rtol=2e-4)


# K2's backward kernel: the serving and recipe shapes (N = 1 and 8, 30x40, D = 12), a map
# smaller than the cluster, a single step, two row tiles, two column tiles, and a pose that
# puts most samples outside the map; the three variants.
@pytest.mark.parametrize("n,h,w,d,shift", [(1, 30, 40, 12, 0.0), (8, 30, 40, 12, 0.0),
                                           (2, 4, 5, 5, 0.0), (2, 30, 40, 2, 0.0),
                                           (1, 80, 64, 3, 0.0), (2, 20, 72, 3, 0.0),
                                           (2, 30, 40, 4, 0.4)])
@pytest.mark.parametrize("variant", ["f32", "tf32", "bf16"])
def test_chain_backward_kernel_matches_its_closed_form(dev, n, h, w, d, shift, variant):
    """K2's backward kernel against ``incremental_chain_backward_plain`` (closed form) on
    what its forward kept: every gradient (feats0, image_rest, H_inc and each refiner
    parameter) within 1e-4 of max|plain| in 3xTF32, 1e-3 in 1xTF32 (each conv operand
    rounded to TF32 on both sides, their sums in another order) and 1e-2 at bf16 (the
    same with bf16 operands); the kept forward bit-equal to the one that keeps nothing,
    and what it kept (the chain, raw h and raw r, the GroupNorms' mean and rstd) against
    the forward kernel's plain version (``incremental_chain_saved_plain``) within 1e-4,
    1e-3 and 5e-2 of max|plain| (chip_smoke.py ``CHAIN_LEGS``' "forward"); two backward
    launches a call (the sequential part and the weight-gradient pass) and no forward
    launch; each launch alone against its plain part within the same bar: the sequential
    part's kept maps (each step's conv0 and resblock output gradients, every carry's
    gradient) and the blocks' (d gamma, d beta) summed, and the pass on those maps."""
    refiner, feats0, image_rest, H_inc = chain_case(n, h, w, d, shift, seed=n + d, dev=dev)
    dtype = torch.bfloat16 if variant == "bf16" else torch.float32
    tf32 = variant == "tf32"
    bar = {"f32": 1e-4, "tf32": 1e-3, "bf16": 1e-2}[variant]
    forward_bar = {"f32": 1e-4, "tf32": 1e-3, "bf16": 5e-2}[variant]
    f0, im = feats0.to(dtype), image_rest.to(dtype)
    weights = chain._weight_args(refiner)
    with torch.no_grad():
        out, raw, stats = chain._forward_launch(f0, im, H_inc, *weights, 0, tf32, True)
        assert torch.equal(out, chain._forward_launch(f0, im, H_inc, *weights, 0, tf32)[0])
        plain = chain.incremental_chain_saved_plain(refiner, f0, im, H_inc, tf32)
        floor = 1e-4 * plain[2].abs().max()  # a mean near 0 held to the statistics' scale
        for a, r in ((out, plain[0]), (raw, plain[1]), (stats[..., 0, :], plain[2][..., 0, :]),
                     (stats[..., 1, :], plain[2][..., 1, :])):
            assert a.shape == r.shape and torch.isfinite(a).all()
            assert ((a.float() - r.float()).abs().max()
                    <= forward_bar * torch.maximum(r.float().abs().max(), floor))
        cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(d)).to(dev, dtype)
        before, bwd_before = counts(), chain.backward_launches
        got = chain._launch_backward(refiner, im, H_inc, weights, out, raw, stats, cot,
                                     (True, True, True), 0, tf32)
        torch.cuda.synchronize()
        assert counts() == before and chain.backward_launches == bwd_before + 2
        ref = chain.incremental_chain_backward_plain(refiner, f0, im, H_inc, out, raw, stats,
                                                     cot, (True, True, True, True), tf32)
        seq = chain.incremental_chain_sequential(im, H_inc, *weights, out, raw, stats, cot,
                                                 (True, True, True), 0, tf32)
        seq_ref = chain.incremental_chain_sequential_plain(refiner, f0, im, H_inc, out, raw,
                                                           stats, cot, (True, True), tf32)
        wg = chain.incremental_chain_wgrad(im, H_inc, weights[3], out, raw, stats, *seq[3:],
                                           tf32)
        by_name = dict(zip((name for name, _, _ in chain.LAYOUT),
                           chain.incremental_chain_wgrad_plain(
                               refiner, im, H_inc, out, raw, stats, *seq[3:5],
                               seq[5].sum(0), tf32)))
        wg_ref = [chain._taps(by_name[n]) for n in ("conv0.weight", "res0.conv1.weight",
                                                     "conv_final.weight")]
        wg_ref.append(torch.stack([by_name[n] for n, kind, _ in chain.LAYOUT if kind == "vec"]))
    pairs = [(got[0], ref[0]), (got[1], ref[1]), (got[2], ref[2]), *zip(got[3], ref[3]),
             (seq[3], seq_ref[3]), (seq[4], seq_ref[4]), (seq[5].sum(0), seq_ref[5]),
             *zip(wg, wg_ref)]
    for a, r in pairs:
        assert a.shape == r.shape and torch.isfinite(a).all()
        assert (a.float() - r.float()).abs().max() <= bar * r.float().abs().max()


def test_chain_function_launches_the_backward_kernel_once(dev):
    """K2's Function: the forward kernel once (keeping its tensors), the backward's two
    launches once each and no forward kernel in the backward; gradients of feats0, image_rest, H_inc and
    every weight at their inputs' dtypes, within 1e-4 of max|plain| of the closed form on
    what the forward kept (the closed form against autograd through the same forward:
    tests/test_torch_chain_backward.py; against plain autograd through another forward the
    two may take two LeakyReLU branches, chip_smoke.py ``chain_legs``). A cluster size the
    card refuses raises, in the backward as in the forward."""
    refiner, feats0, image_rest, H_inc = chain_case(1, 30, 40, 12, 0.0, seed=3, dev=dev)
    leaves = [t.clone().requires_grad_() for t in (feats0, image_rest, H_inc)]
    params = list(refiner.parameters())
    cot = torch.randn(1, 12, 30, 40, 32, generator=torch.Generator().manual_seed(5)).to(dev)
    before, bwd_before = counts(), chain.backward_launches
    out = chain.incremental_chain(refiner, *leaves)
    got = torch.autograd.grad(out, leaves + params, cot)
    torch.cuda.synchronize()
    assert counts()[1] == before[1] + 1 and chain.backward_launches == bwd_before + 2
    with torch.no_grad():
        kept = chain._forward_launch(feats0, image_rest, H_inc, *chain._weight_args(refiner),
                                     0, False, True)
        assert torch.equal(kept[0], out)
        d_feats0, d_image, d_H, d_params = chain.incremental_chain_backward_plain(
            refiner, feats0, image_rest, H_inc, *kept, cot)
    ref = [d_feats0, d_image, d_H, *d_params]
    floor = 1e-4 * max(r.abs().max().item() for r in ref)
    for a, r, leaf in zip(got, ref, leaves + params):
        assert a.dtype == leaf.dtype
        assert (a - r).abs().max().item() <= 1e-4 * max(r.abs().max().item(), floor)
    with torch.no_grad():
        with pytest.raises(RuntimeError, match="failed to launch"):
            chain.incremental_chain_backward(image_rest, H_inc, *chain._weight_args(refiner),
                                             *kept, torch.zeros_like(kept[0]), cluster=17)


def test_chain_cluster_size_and_refused_launch(dev):
    """16 blocks a sample at the serving shape; a cluster size the card refuses raises,
    counts no launch, and leaves no error behind for the next launch."""
    assert chain.cluster_size(1, 30, 40) == 16
    assert chain.cluster_size(5, 30, 40) in (8, 16)
    refiner, feats0, image_rest, H_inc = chain_case(1, 30, 40, 4, 0.0, seed=0, dev=dev)
    with torch.inference_mode():
        before = chain.launches
        with pytest.raises(RuntimeError, match="failed to launch"):
            chain.incremental_chain_kernel(refiner, feats0, image_rest, H_inc, cluster=32)
        assert chain.launches == before
        got = chain.incremental_chain(refiner, feats0, image_rest, H_inc)
        ref = chain.incremental_chain(refiner, feats0, image_rest, H_inc, impl="plain")
    torch.cuda.synchronize()
    assert torch.allclose(got, ref, atol=2e-5 * ref.abs().max().item(), rtol=2e-4)


# K2's 1xTF32 variant at the serving shapes, one step, and a map of two column tiles.
@pytest.mark.parametrize("n,h,w,d", [(1, 30, 40, 12), (8, 30, 40, 12), (2, 30, 40, 2),
                                     (1, 20, 72, 6)])
def test_chain_tf32_kernel_matches_its_plain_version(dev, n, h, w, d):
    refiner, feats0, image_rest, H_inc = chain_case(n, h, w, d, 0.0, seed=n + d, dev=dev)
    with torch.inference_mode():
        exact = chain.incremental_chain_kernel(refiner, feats0, image_rest, H_inc)
        before = (chain.launches, chain.tf32_launches)
        got = chain.incremental_chain_kernel(refiner, feats0, image_rest, H_inc, tf32=True)
        assert (chain.launches, chain.tf32_launches) == (before[0] + 1, before[1] + 1)
        ref = chain.incremental_chain_tf32_plain(refiner, feats0, image_rest, H_inc)
        again = chain.incremental_chain_kernel(refiner, feats0, image_rest, H_inc)
    torch.cuda.synchronize()
    assert got.shape == (n, d, h, w, 32) and torch.isfinite(got).all()
    assert (got - ref).abs().max().item() <= 1e-3 * ref.abs().max().item()
    assert torch.equal(again, exact) and not torch.equal(got, exact)


# K3's 1xTF32 variant at the serving shapes, the image-only refiner and an odd map.
@pytest.mark.parametrize("n,cg,h,w", [(1, 35, 30, 40), (8, 35, 30, 40), (1, 35, 60, 80),
                                      (2, 3, 16, 24), (2, 35, 7, 13)])
def test_refiner_tf32_kernel_matches_its_plain_version(dev, n, cg, h, w):
    module = idepthmap_refiner_module(cg, seed=n, dev=dev)
    g = torch.Generator().manual_seed(h)
    guidance = (torch.rand(n, cg, h, w, generator=g) * 2 - 1).to(dev)
    idepth = (torch.rand(n, h, w, generator=g) * 20).to(dev)
    with torch.inference_mode():
        exact = refiner_op.idepthmap_refiner_kernel(module, guidance, idepth)
        before = (refiner_op.launches, refiner_op.tf32_launches)
        got = refiner_op.idepthmap_refiner_kernel(module, guidance, idepth, tf32=True)
        assert (refiner_op.launches, refiner_op.tf32_launches) == (before[0] + 1,
                                                                   before[1] + 1)
        ref = refiner_op.idepthmap_refiner_tf32_plain(module, guidance, idepth)
        again = refiner_op.idepthmap_refiner_kernel(module, guidance, idepth)
    torch.cuda.synchronize()
    assert got.shape == (n, h, w) and torch.isfinite(got).all()
    assert (got - ref).abs().max().item() <= 3e-4 * ref.abs().max().item()
    assert torch.equal(again, exact) and not torch.equal(got, exact)


def test_forward_at_high_launches_the_tf32_variants(dev):
    """A forward at matmul_precision "high" launches K2's and K3's 1xTF32 variants and
    lies within 1% of each level's range of the forward at "highest"; the caller's
    cuDNN flag (off here) is off again after it."""
    model = MultiViewStereoNet()
    model.load_state_dict(random_state_dict(0))
    model = model.to(dev).eval()
    K, T = scene(1, 480, 640, 3)
    K_pyr = build_K_pyramid(K.to(dev), [(480 >> i, 640 >> i) for i in range(5)])
    g = torch.Generator().manual_seed(3)
    left = build_image_pyramid((torch.rand(1, 480, 640, 3, generator=g) * 2 - 1).to(dev), 5)
    right = build_image_pyramid((torch.rand(1, 480, 640, 3, generator=g) * 2 - 1).to(dev), 5)
    rights = [r[:, None] for r in right]
    out = {}
    with torch.inference_mode():
        for name in ("highest", "high"):
            before = (chain.tf32_launches, refiner_op.tf32_launches)
            out[name] = mvsnet_forward(model, left, K_pyr, T.to(dev)[:, None], rights,
                                       MultiViewStereoNetConfig(matmul_precision=name))
            tf32 = (chain.tf32_launches - before[0], refiner_op.tf32_launches - before[1])
            assert tf32 == ((0, 0) if name == "highest" else (1, 2))
            assert not torch.backends.cudnn.allow_tf32
    for got, ref in zip(out["high"]["left_idepthmap_pyr"], out["highest"]["left_idepthmap_pyr"]):
        span = (ref.max() - ref.min()).item()
        assert (got - ref).abs().max().item() <= 1e-2 * span


def idepthmap_refiner_module(cg, seed, dev):
    """A seeded fan-in-scale IDepthmapRefiner: refiner4's weights (cg = 35) or
    refiner0's (cg = 3)."""
    prefix = "refiner4." if cg == 35 else "refiner0."
    module = IDepthmapRefiner(cg)
    module.load_state_dict({k[len(prefix):]: v for k, v in random_state_dict(seed).items()
                            if k.startswith(prefix)})
    return module.to(dev).eval()


# The serving shapes (level 4 at N = B*V = 1, 2, 5 and 8, level 3 at N = B = 1 and 8, the
# latter several passes of m-tiles a block), the image-only refiner, maps whose h*w is
# not a multiple of the kernel's 16-pixel m-tile (7x13, and 4x5, smaller than the
# dilation-8 taps), and 8 samples whose m-tile ranges cross sample boundaries.
@pytest.mark.parametrize("n,cg,h,w", [(1, 35, 30, 40), (2, 35, 30, 40), (5, 35, 30, 40),
                                      (8, 35, 30, 40), (1, 35, 60, 80), (8, 35, 60, 80),
                                      (2, 3, 16, 24), (2, 35, 7, 13), (3, 35, 4, 5),
                                      (8, 35, 9, 11)])
def test_refiner_kernel_matches_plain(dev, n, cg, h, w):
    module = idepthmap_refiner_module(cg, seed=n, dev=dev)
    g = torch.Generator().manual_seed(h)
    guidance = (torch.rand(n, cg, h, w, generator=g) * 2 - 1).to(dev)
    idepth = (torch.rand(n, h, w, generator=g) * 20).to(dev)
    with torch.inference_mode():
        before = refiner_op.launches
        got = refiner_op.idepthmap_refiner(module, guidance, idepth)
        ref = refiner_op.idepthmap_refiner(module, guidance, idepth, impl="plain")
    torch.cuda.synchronize()
    assert refiner_op.launches == before + 1
    assert got.shape == (n, h, w) and torch.isfinite(got).all()
    assert torch.allclose(got, ref, atol=REFINER_ATOL * ref.abs().max().item(),
                          rtol=REFINER_RTOL)
    # The refiner moves the map: a kernel returning ReLU(idepth) would not pass.
    assert (ref - torch.relu(idepth)).abs().mean().item() > 0.01


# K3's backward kernel: the serving and recipe shapes (level 4 at N = 1 and 8, level 3 at N
# = 1 and 8), the image-only refiner, a map whose h*w is not a multiple of the m-tile and
# one smaller than the dilation-8 taps; the three variants.
@pytest.mark.parametrize("n,cg,h,w", [(1, 35, 30, 40), (8, 35, 30, 40), (1, 35, 60, 80),
                                      (8, 35, 60, 80), (2, 3, 16, 24), (2, 35, 7, 13),
                                      (3, 35, 4, 5)])
@pytest.mark.parametrize("variant", ["f32", "tf32", "bf16"])
def test_refiner_backward_kernel_matches_its_closed_form(dev, n, cg, h, w, variant):
    """K3's backward kernel against ``idepthmap_refiner_backward_plain`` (closed form) on
    what its forward kept: every gradient (guidance, idepth and each refiner parameter)
    within 1e-4 of max|plain| in 3xTF32, 1e-3 in 1xTF32 (each conv operand rounded to TF32
    on both sides, their sums in another order) and 2e-2 at bf16 (the same with bf16
    operands); the kept forward bit-equal to the one that keeps nothing, and what it kept
    (the output, each GroupNorm layer's raw conv output, the statistics) against the
    forward kernel's plain version within 1e-4, 1e-3 and 5e-2 of max|plain|; two backward
    launches a call (the sequential part and the weight-gradient pass) and no forward
    launch; two runs bit-equal; each launch alone against its plain part within the same
    bar: the sequential part's kept maps (each GroupNorm layer's dT_l, gout) and the
    blocks' (d gamma, d beta) summed, and the pass on those maps."""
    module = idepthmap_refiner_module(cg, seed=n, dev=dev)
    g = torch.Generator().manual_seed(h)
    dtype = torch.bfloat16 if variant == "bf16" else torch.float32
    tf32 = variant == "tf32"
    bar = {"f32": 1e-4, "tf32": 1e-3, "bf16": 2e-2}[variant]
    forward_bar = {"f32": 1e-4, "tf32": 1e-3, "bf16": 5e-2}[variant]
    guidance = (torch.rand(n, cg, h, w, generator=g) * 2 - 1).to(dev, dtype)
    idepth = (torch.rand(n, h, w, generator=g) * 20).to(dev)
    cot = torch.randn(n, h, w, generator=g).to(dev)
    with torch.no_grad():
        out, saved = refiner_op._launch(module, guidance, idepth, tf32, keep=True)
        raw, stats, hs, pack = saved
        assert torch.equal(out, refiner_op._launch(module, guidance, idepth, tf32))
        plain = refiner_op.idepthmap_refiner_saved_plain(module, guidance, idepth, tf32)
        floor = 1e-4 * plain[2].abs().max()  # a mean near 0 held to the statistics' scale
        for a, r in ((out, plain[0]), (raw, plain[1]), (stats[:, :, 0], plain[2][:, :, 0]),
                     (stats[:, :, 1], plain[2][:, :, 1])):
            assert a.shape == r.shape and torch.isfinite(a).all()
            assert (a - r).abs().max() <= forward_bar * torch.maximum(r.abs().max(), floor)
        assert torch.isfinite(hs).all()
        needs = (True, True, True)
        before, bwd_before = counts(), refiner_op.backward_launches
        got = refiner_op._launch_backward(module, guidance, idepth, out, saved, cot, needs,
                                          tf32)
        again = refiner_op._launch_backward(module, guidance, idepth, out, saved, cot, needs,
                                            tf32)
        torch.cuda.synchronize()
        assert counts() == before and refiner_op.backward_launches == bwd_before + 4
        ref = refiner_op.idepthmap_refiner_backward_plain(module, guidance, idepth, out, raw,
                                                          stats, cot, needs, tf32)
        dil = refiner_op._dilations(module)
        seq = refiner_op.idepthmap_refiner_sequential(guidance, idepth, pack, dil, out, raw,
                                                      stats, hs, cot, True, tf32)
        seq_ref = refiner_op.idepthmap_refiner_sequential_plain(module, guidance, idepth, out,
                                                                raw, stats, cot, tf32)
        gn = seq[4].sum(0).float()
        wg = refiner_op._unpack_grads(module, refiner_op.idepthmap_refiner_wgrad(
            guidance, idepth, dil, hs, seq[2], seq[3], seq[4], tf32))
        wg_ref = refiner_op.idepthmap_refiner_wgrad_plain(module, guidance, idepth, raw, stats,
                                                          seq[2], seq[3], gn, tf32)
    got, again, ref = ([t[0], t[1], *t[2]] for t in (got, again, ref))
    assert got[0].dtype == dtype
    for a, b, r in zip(got, again, ref):
        assert a.shape == r.shape and torch.isfinite(a).all() and torch.equal(a, b)
        assert (a.float() - r.float()).abs().max() <= bar * r.float().abs().max()
    for a, r in ((seq[2], seq_ref[2]), (seq[3], seq_ref[3]), (gn, seq_ref[4]),
                 *zip(wg, wg_ref)):
        assert a.shape == r.shape and torch.isfinite(a).all()
        assert (a.float() - r.float()).abs().max() <= bar * r.float().abs().max()


def test_refiner_function_launches_the_backward_kernel_once(dev):
    """K3's Function: the forward kernel once (keeping its tensors), the backward's two
    launches once each and no forward kernel in the backward; gradients of guidance, idepth and every
    weight at their inputs' dtypes, within 1e-4 of max|plain| of the closed form on what
    the forward kept; without the guidance's gradient the kernel writes none."""
    module = idepthmap_refiner_module(35, seed=2, dev=dev)
    g = torch.Generator().manual_seed(5)
    guidance = (torch.rand(2, 35, 30, 40, generator=g) * 2 - 1).to(dev)
    idepth = (torch.rand(2, 30, 40, generator=g) * 20).to(dev)
    cot = torch.randn(2, 30, 40, generator=g).to(dev)
    leaves = [guidance.clone().requires_grad_(), idepth.clone().requires_grad_()]
    params = list(module.parameters())
    before, bwd_before = counts(), refiner_op.backward_launches
    out = refiner_op.idepthmap_refiner(module, *leaves)
    got = torch.autograd.grad(out, leaves + params, cot)
    torch.cuda.synchronize()
    assert counts()[2] == before[2] + 1 and refiner_op.backward_launches == bwd_before + 2
    with torch.no_grad():
        kept, (raw, stats, _, _) = refiner_op._launch(module, guidance, idepth, False, True)
        assert torch.equal(kept, out)
        d_g, d_i, d_params = refiner_op.idepthmap_refiner_backward_plain(
            module, guidance, idepth, kept, raw, stats, cot)
    for a, r, leaf in zip(got, [d_g, d_i, *d_params], leaves + params):
        assert a.dtype == leaf.dtype
        assert (a - r).abs().max().item() <= 1e-4 * r.abs().max().item()
    out = refiner_op.idepthmap_refiner(module, guidance, leaves[1])
    d_i2, = torch.autograd.grad(out, [leaves[1]], cot)
    assert torch.equal(d_i2, got[1])


def test_refiner_function_under_remat_holds_no_kept_maps(dev):
    """Under ``remat_refiners``' checkpoint (non-reentrant, as ``_refine_level`` runs it)
    K3's Function holds none of its forward's kept maps from the forward to the backward:
    at the recipe's (8, 35, 60, 80) the memory held after the forward is, without the
    checkpoint, at least the fourteen kept (N, h, w, 32) f32 maps, and with it less than
    that by at least as much; the gradients are the same bits."""
    module = idepthmap_refiner_module(35, seed=3, dev=dev)
    n, h, w = 8, 60, 80
    g = torch.Generator().manual_seed(9)
    guidance = (torch.rand(n, 35, h, w, generator=g) * 2 - 1).to(dev).requires_grad_()
    idepth = (torch.rand(n, h, w, generator=g) * 20).to(dev).requires_grad_()
    cot = torch.randn(n, h, w, generator=g).to(dev)
    maps = 2 * refiner_op.NUM_GN * n * h * w * refiner_op.C * 4

    def run(remat):
        def refine(gd, i):
            return refiner_op.idepthmap_refiner(module, gd, i)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        out = (torch.utils.checkpoint.checkpoint(refine, guidance, idepth, use_reentrant=False)
               if remat else refine(guidance, idepth))
        held = torch.cuda.memory_allocated(dev) - base
        return held, torch.autograd.grad(out, [guidance, idepth], cot)
    held, want = run(False)
    held_remat, got = run(True)
    assert held >= maps and held_remat <= held - maps, (held, held_remat, maps)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_refiner_kernel_follows_weight_updates(dev):
    """The kernel's packed weights are reused while the parameters are unchanged and
    repacked after an in-place update and after load_state_dict: each time the kernel's
    output follows the plain path's."""
    module = idepthmap_refiner_module(35, seed=7, dev=dev)
    g = torch.Generator().manual_seed(7)
    guidance = (torch.rand(1, 35, 30, 40, generator=g) * 2 - 1).to(dev)
    idepth = (torch.rand(1, 30, 40, generator=g) * 20).to(dev)

    def check():
        with torch.inference_mode():
            got = refiner_op.idepthmap_refiner(module, guidance, idepth)
            ref = refiner_op.idepthmap_refiner(module, guidance, idepth, impl="plain")
        torch.cuda.synchronize()
        assert torch.allclose(got, ref, atol=REFINER_ATOL * ref.abs().max().item(),
                              rtol=REFINER_RTOL)
        return got

    first = check()
    pack = refiner_op.packed_weights(module)[0]
    check()
    assert refiner_op.packed_weights(module)[0] is pack
    with torch.no_grad():
        module.res3.conv1.weight.mul_(-1.5)
        module.conv_final.bias.add_(0.25)
    second = check()
    assert refiner_op.packed_weights(module)[0] is not pack
    assert (second - first).abs().max().item() > 1e-3
    module.load_state_dict(idepthmap_refiner_module(35, seed=8, dev=dev).state_dict())
    third = check()
    assert (third - second).abs().max().item() > 1e-3


def test_refiner_kernel_follows_new_storage_and_invalidation(dev):
    """``p.data = ...`` gives new storage at the same version: the pack follows it. An
    in-place write through ``.data`` keeps both, and after ``invalidate_packed_weights``
    the next launch packs the new weights. Each time the kernel matches its plain
    version at (1,35,30,40)."""
    module = idepthmap_refiner_module(35, seed=9, dev=dev)
    g = torch.Generator().manual_seed(9)
    guidance = (torch.rand(1, 35, 30, 40, generator=g) * 2 - 1).to(dev)
    idepth = (torch.rand(1, 30, 40, generator=g) * 20).to(dev)

    def check():
        with torch.inference_mode():
            before = refiner_op.launches
            got = refiner_op.idepthmap_refiner(module, guidance, idepth)
            ref = refiner_op.idepthmap_refiner(module, guidance, idepth, impl="plain")
        torch.cuda.synchronize()
        assert refiner_op.launches == before + 1
        assert torch.allclose(got, ref, atol=REFINER_ATOL * ref.abs().max().item(),
                              rtol=REFINER_RTOL)
        return got

    first = check()
    versions = [p._version for p in module.parameters()]
    module.res2.conv1.weight.data = module.res2.conv1.weight.data * -1.5
    second = check()
    assert [p._version for p in module.parameters()] == versions
    assert (second - first).abs().max().item() > 1e-3
    module.conv0.weight.data.mul_(0.5)
    refiner_op.invalidate_packed_weights(module)
    third = check()
    assert (third - second).abs().max().item() > 1e-3


def test_dequantize_on_the_card_is_bit_exact_for_all_256_values(dev):
    from multi_view_stereonet_tpu_torch.ops.quantize import (
        dequantize_images_u8, dequantize_images_u8_unit)

    u = np.arange(256, dtype=np.uint8)
    unit = u.astype(np.float32) / 255.0
    full = unit * 2.0 - 1.0
    u_dev = torch.from_numpy(u).to(dev)
    got_full = dequantize_images_u8(u_dev).cpu().numpy()
    got_unit = dequantize_images_u8_unit(u_dev).cpu().numpy()
    np.testing.assert_array_equal(got_full.view(np.int32), full.view(np.int32))
    np.testing.assert_array_equal(got_unit.view(np.int32), unit.view(np.int32))


def gn_case(shape, residual, dev):
    """x (off-centre, as a conv output is), weight, bias and res (or None) on the card."""
    g = torch.Generator().manual_seed(shape[2])
    x = (torch.randn(shape, generator=g) * 3 + 1).to(dev)
    res = torch.randn(shape, generator=g).to(dev) if residual else None
    weight = (torch.rand(shape[1], generator=g) + 0.5).to(dev)
    bias = (torch.randn(shape[1], generator=g) * 0.1).to(dev)
    return x, weight, bias, res


def assert_gn_matches_plain(got, x, weight, bias, res):
    ref = gn_apply.group_norm_act(x, weight, bias, x.shape[1] // 8, res, impl="plain")
    torch.cuda.synchronize()
    assert got.shape == ref.shape
    assert (got - ref).abs().max().item() <= GN_BAR * max(1.0, ref.abs().max().item())


# The serving shapes (extractor at level 4, refiner levels 2, 1 and 0, the cost
# filter at N = B*V = 1 and 5) and a map whose H*W is not a multiple of 4 (the
# scalar path), with the residual (resblock tails) and without (bn0, the filter).
@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("shape", [(2, 32, 30, 40), (1, 32, 120, 160), (1, 32, 240, 320),
                                   (1, 32, 480, 640), (1, 32, 12, 30, 40),
                                   (5, 32, 12, 30, 40), (3, 32, 5, 7)])
def test_gn_apply_kernel_matches_plain(dev, shape, residual):
    x, weight, bias, res = gn_case(shape, residual, dev)
    before = gn_apply.launches
    got = gn_apply.group_norm_act(x, weight, bias, shape[1] // 8, res)
    torch.cuda.synchronize()
    assert gn_apply.launches == before + 1
    assert_gn_matches_plain(got, x, weight, bias, res)


@pytest.mark.parametrize("shape,residual", [((1, 32, 120, 160), True),
                                            ((5, 32, 12, 30, 40), False)])
def test_gn_kernel_unaligned_takes_scalar_loads(dev, shape, residual):
    """Tensors that start off a 16-byte boundary take the scalar (non-float4) loads."""
    x, weight, bias, res = gn_case(shape, residual, dev)

    def unaligned(t):
        return None if t is None else torch.cat([t.new_zeros(1), t.flatten()])[1:].view(shape)
    x, res = unaligned(x), unaligned(res)
    assert x.data_ptr() % 16
    got = gn_apply.group_norm_act_kernel(x, weight, bias, 4, res)
    assert_gn_matches_plain(got, x, weight, bias, res)


# K4's forward and backward shapes: the serving forward's (B = 1, V = 1 and 5), the
# recipe's training step (B = 8, V = 1, 480x640) and the convergence recipe's (96x128,
# B = 4), each (shape, residual).
GN_ROUTE_SHAPES = [((2, 32, 30, 40), True), ((1, 32, 120, 160), True),
                   ((1, 32, 240, 320), True), ((1, 32, 480, 640), True),
                   ((1, 32, 480, 640), False), ((1, 32, 12, 30, 40), False),
                   ((5, 32, 12, 30, 40), False), ((16, 32, 30, 40), True),
                   ((8, 32, 480, 640), True), ((8, 32, 480, 640), False),
                   ((8, 32, 12, 30, 40), False), ((8, 32, 6, 8), True),
                   ((4, 32, 96, 128), True), ((4, 32, 96, 128), False),
                   ((4, 32, 12, 6, 8), False)]
GN_F32_FLOOR = 2.0 ** -21  # chip_smoke.py's: a bf16 GroupNorm value that nearly cancels


def gn_bf16_within_a_rounding(got, ref, x, weight, bias, xbias):
    """Phase 11's bar (chip_smoke.py): within one bf16 ulp of the f32 GroupNorm value and
    one of the plain result at each element, plus GN_F32_FLOOR of |x_hat gamma| + |beta|."""
    channel = (1, -1) + (1,) * (x.ndim - 2)
    x32 = x.float() + xbias.reshape(channel)
    y = torch.nn.functional.group_norm(x32, 4, weight, bias, gn_apply.EPS)
    terms = ((torch.nn.functional.group_norm(x32, 4, eps=gn_apply.EPS)
              * weight.reshape(channel)).abs() + bias.abs().reshape(channel))
    bar = bf16_ulp(y) + bf16_ulp(ref) + GN_F32_FLOOR * terms
    return bool(torch.all((got.float() - ref.float()).abs() <= bar))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,residual", GN_ROUTE_SHAPES)
def test_gn_forward_routes_match_plain(dev, shape, residual, dtype):
    """The forward at every serving and recipe shape: f32 within 1e-5 * max(1,
    max|plain|), bf16 (with a conv bias as xbias) within phase 11's rounding bar; the
    statistics it writes within 1e-6 relative of the plain ones (f64 sums both); two calls
    bit-equal."""
    x, weight, bias, res = gn_case(shape, residual, dev)
    x = x.to(dtype)
    res = None if res is None else res.to(dtype)
    xbias = (0.3 * torch.randn(shape[1], generator=torch.Generator().manual_seed(1))).to(dev)
    xbias = xbias if dtype == torch.bfloat16 else None
    got, stats = gn_apply._forward_launch(x, weight, bias, res, 4, xbias, stats=True)
    again = gn_apply._forward_launch(x, weight, bias, res, 4, xbias)
    ref = gn_apply.group_norm_act_plain(x, weight, bias, 4, res, xbias)
    plain_stats = gn_apply.group_stats_plain(x, 4, xbias)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.equal(got, again)
    assert torch.allclose(stats, plain_stats, rtol=1e-6, atol=1e-7)
    if dtype == torch.float32:
        assert (got - ref).abs().max().item() <= GN_BAR * max(1.0, ref.abs().max().item())
    else:
        assert gn_bf16_within_a_rounding(got, ref, x, weight, bias, xbias)


KINK_ROUNDING, KINK_SHARE, KINK_FLOOR = 2.0 ** -16, 1e-4, 8  # chip_smoke.py's


def gn_kink_mask(x, weight, bias, xbias):
    """False where the GroupNorm value z lies within KINK_ROUNDING (|x_hat gamma| + |beta|
    + |mean rstd gamma|) of LeakyReLU's kink, z from f64 statistics of x (+ xbias) alone:
    there the kernel's f64 statistics and F.group_norm's f32 ones may put z on two sides
    (chip_smoke.py ``gn_kink_mask``)."""
    N, C = x.shape[:2]
    v = x.double().reshape(N, 4, -1)
    if xbias is not None:
        v = v + xbias.double().reshape(4, -1).repeat_interleave(v.shape[2] // (C // 4), 1)
    mean = v.mean(2, keepdim=True)
    rstd = 1.0 / torch.sqrt(((v - mean) ** 2).mean(2, keepdim=True) + gn_apply.EPS)
    v = v.reshape(N, C, -1)
    mean, rstd = mean.repeat_interleave(C // 4, 1), rstd.repeat_interleave(C // 4, 1)
    gamma, beta = weight.double().reshape(1, C, 1), bias.double().reshape(1, C, 1)
    xg = (v - mean) * rstd * gamma
    terms = xg.abs() + beta.abs() + (mean * rstd * gamma).abs()
    return ((xg + beta).abs() > KINK_ROUNDING * terms).reshape(x.shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,residual", GN_ROUTE_SHAPES)
def test_gn_backward_kernel_matches_plain_and_autograd(dev, shape, residual, dtype):
    """The backward kernel against its plain version on the same statistics and gradient
    (every gradient within 1e-4 of max|plain|), bit-equal over two calls; K4's Function
    (forward kernel, backward kernel: one launch each, counted apart) against plain
    autograd through ``group_norm_act_plain``, within phase 3b's bar at f32 (1e-4 of
    max|autograd|) and phase 12's at bf16 (1e-2), the output's gradient 0 at the elements
    within a rounding of LeakyReLU's kink (at most KINK_SHARE of them, or KINK_FLOOR);
    d res is the output's gradient."""
    x, weight, bias, res = gn_case(shape, residual, dev)
    x = x.to(dtype)
    res = None if res is None else res.to(dtype)
    xbias = None
    if dtype == torch.bfloat16:
        xbias = (0.3 * torch.randn(shape[1], generator=torch.Generator().manual_seed(2))).to(dev)
    g = torch.Generator().manual_seed(3)
    dy = torch.randn(shape, generator=g).to(dev, dtype)
    _, stats = gn_apply._forward_launch(x, weight, bias, res, 4, xbias, stats=True)
    got = gn_apply.group_norm_act_backward(x, weight, bias, 4, stats, dy, xbias)
    again = gn_apply.group_norm_act_backward(x, weight, bias, 4, stats, dy, xbias)
    ref = gn_apply.group_norm_act_backward_plain(x, weight, bias, 4, stats, dy, xbias)
    torch.cuda.synchronize()
    assert got[0].dtype == dtype and (got[3] is None) == (xbias is None)
    for a, b, r in zip(got, again, ref):
        if r is None:
            continue
        assert torch.equal(a, b)
        assert (a.float() - r.float()).abs().max() <= 1e-4 * r.float().abs().max()
    leaves = [t.detach().clone().requires_grad_() if t is not None else None
              for t in (x, weight, bias, res, xbias)]
    operands = [t for t in leaves if t is not None]
    before, bwd_before = gn_apply.launches, gn_apply.backward_launches
    out = gn_apply.group_norm_act(leaves[0], leaves[1], leaves[2], 4, leaves[3],
                                  xbias=leaves[4])
    away = gn_kink_mask(x, weight, bias, xbias)
    kink = away.numel() - int(away.sum())
    assert kink <= max(KINK_FLOOR, KINK_SHARE * away.numel())
    dy_away = dy * away
    kernel = torch.autograd.grad(out, operands, dy_away)
    assert (gn_apply.launches - before, gn_apply.backward_launches - bwd_before) == (1, 1)
    plain = torch.autograd.grad(
        gn_apply.group_norm_act_plain(leaves[0], leaves[1], leaves[2], 4, leaves[3],
                                      leaves[4]), operands, dy_away)
    assert gn_apply.backward_launches - bwd_before == 1
    if residual:
        assert torch.equal(kernel[3], dy_away)
    bar = 1e-4 if dtype == torch.float32 else 1e-2
    floor = 1e-4 * max(p.float().abs().max().item() for p in plain)
    for k, p in zip(kernel, plain):
        assert k.dtype == p.dtype
        scale = max(p.float().abs().max().item(), floor)
        assert (k.float() - p.float()).abs().max().item() <= bar * scale


def test_gn_launch_error_raises(dev):
    """A launch the card refuses raises, counts nothing, never runs the plain version
    instead, and leaves no error behind for the next launch: the forward with more than
    65535 (sample, group) rows in its grid's y dimension, and the backward's cooperative
    grid forced to more blocks than the card holds at once."""
    x, weight, bias, res = gn_case((1, 32, 120, 160), True, dev)
    before, bwd_before = gn_apply.launches, gn_apply.backward_launches
    with pytest.raises(RuntimeError, match="failed to launch"):
        gn_apply.group_norm_act_kernel(torch.zeros(16400, 32, 2, 2, device=dev), weight,
                                       bias, 4)
    sms = gn_apply.sm_count(dev)
    big = torch.zeros(1, 32, 480, 640, device=dev)
    p = gn_apply.plan(big.shape, 4, big.dtype, sms, backward=True)
    q = -(-big.numel() // (sms + 1) // 8) * 8
    stats = torch.zeros(4, 2, device=dev)
    with pytest.raises(RuntimeError, match="failed to launch"):
        gn_apply.group_norm_act_backward(big, weight, bias, 4, stats, big, route=p._replace(
            blocks=sms + 1, slice=q, held=gn_apply.HOLD_BYTES // 8))
    assert (gn_apply.launches, gn_apply.backward_launches) == (before, bwd_before)
    got = gn_apply.group_norm_act_kernel(x, weight, bias, 4, res)
    assert_gn_matches_plain(got, x, weight, bias, res)


def test_forward_kernels_match_plain_and_are_launched(dev):
    model = MultiViewStereoNet()
    model.load_state_dict(random_state_dict(0))
    model = model.to(dev).eval()
    g = torch.Generator().manual_seed(1)
    B, V, H, W = 1, 2, 64, 80
    left = (torch.rand(B, H, W, 3, generator=g) * 2 - 1).to(dev)
    rights = (torch.rand(B * V, H, W, 3, generator=g) * 2 - 1).to(dev)
    K, T = scene(B * V, H, W, seed=2)
    left_pyr = build_image_pyramid(left, 5)
    right_pyrs = [r.reshape(B, V, *r.shape[1:]) for r in build_image_pyramid(rights, 5)]
    K_pyr = build_K_pyramid(K[:B].to(dev), [(p.shape[1], p.shape[2]) for p in left_pyr])
    T = T.reshape(B, V, 4, 4).to(dev)
    config = MultiViewStereoNetConfig(num_idepth_samples=12)
    with torch.inference_mode():
        before = counts()
        got = mvsnet_forward(model, left_pyr, K_pyr, T, right_pyrs, config)
        # At 64x80 the refiners of levels 4..1 are small enough for K3; K4 takes the
        # extractor's six resblocks (one batched call each), refiner0's six and its
        # bn0, and the cost filter's four GroupNorms.
        expected = tuple(b + d for b, d in zip(before, (2, 1, 4, 17)))
        assert counts() == expected
        ref = mvsnet_forward(model, left_pyr, K_pyr, T, right_pyrs, config, impl="plain")
        assert counts() == expected, "impl='plain' launched a kernel"
    for lvl in range(5):
        a, b = got["left_idepthmap_pyr"][lvl], ref["left_idepthmap_pyr"][lvl]
        span = (b.max() - b.min()).item()
        assert torch.isfinite(a).all() and span > 0
        assert (a - b).abs().max().item() <= 2e-3 * span


def test_train_step_kernels_match_plain_and_the_backward_launches_nothing(dev):
    """One loss and backward of the training recipe at 64x80 (B = 2, V = 1, D = 12) from
    the same weights and batch, kernel path against plain: the loss within 1e-5
    relative, every parameter's gradient within docs/PARITY.md:218-232's bar (2.5e-3 of
    max|plain|, cosine > 0.999998; a leaf below 1e-4 of the largest held to that floor).
    The forward launches 2 / 1 / 4 / 17, the backward K4's backward kernel 17 times, K2's
    backward once (its two launches), K1's never and no forward kernel."""
    from multi_view_stereonet_tpu_torch.losses import LossConfig
    from multi_view_stereonet_tpu_torch.train.step import make_loss_fn

    model = MultiViewStereoNet()
    model.load_state_dict(random_state_dict(0))
    model = model.to(dev)
    g = torch.Generator().manual_seed(11)
    B, H, W = 2, 64, 80
    K, T = scene(B, H, W, seed=12)
    depth = torch.rand(B, H, W, generator=g) * 8 + 2
    depth[torch.rand(B, H, W, generator=g) < 0.1] = 0.0
    batch = {"left_image": torch.rand(B, H, W, 3, generator=g) * 2 - 1,
             "right_images": torch.rand(B, 1, H, W, 3, generator=g) * 2 - 1,
             "K": K, "T_right_in_left": T.reshape(B, 1, 4, 4), "left_depthmap_true": depth}
    batch = {k: v.to(dev) for k, v in batch.items()}
    config = MultiViewStereoNetConfig(num_idepth_samples=12)
    results = {}
    for impl in ("auto", "plain"):
        model.zero_grad(set_to_none=True)
        before = counts()
        loss, _ = make_loss_fn(config, LossConfig(), impl=impl)(model, batch)
        forward = tuple(a - b for a, b in zip(counts(), before))
        bwd_before = backward_counts()
        loss.backward()
        torch.cuda.synchronize()
        backward = tuple(a - b for a, b in zip(counts(), before))
        assert forward == backward == ((2, 1, 4, 17) if impl == "auto" else (0, 0, 0, 0))
        # K4's backward kernel once a forward launch and K2's once (counted apart); K1's
        # warps sample data, which needs no gradient.
        assert tuple(a - b for a, b in zip(backward_counts(), bwd_before)) == (
            (0, 2, 17) if impl == "auto" else (0, 0, 0))
        results[impl] = (loss.item(), {k: p.grad.clone() for k, p in model.named_parameters()})
    assert_training_matches_plain(results)


def assert_training_matches_plain(results):
    """results[impl] = (loss, {name: grad}): the kernel path's loss within 1e-5 relative
    of the plain path's and every gradient within docs/PARITY.md:218-232's bar."""
    (loss, got), (ref_loss, ref) = results["auto"], results["plain"]
    assert np.isfinite(loss) and abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)
    floor = 1e-4 * max(v.abs().max().item() for v in ref.values())
    for k, r in ref.items():
        scale = max(r.abs().max().item(), floor)
        assert (got[k] - r).abs().max().item() <= 2.5e-3 * scale, k
        if r.abs().max().item() > floor:
            cos = torch.nn.functional.cosine_similarity(got[k].flatten(), r.flatten(), dim=0)
            assert cos.item() > 1 - 2e-6, (k, cos.item())


def distributed_worker():
    """tests/_torch_distributed_worker.py by path (see ``synthetic_data``)."""
    spec = importlib.util.spec_from_file_location(
        "_torch_distributed_worker", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                  "_torch_distributed_worker.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_two_processes_on_the_card_match_one(dev, tmp_path):
    """Two processes on one card over gloo (NCCL takes no two ranks on one device), each
    its half of a global B = 4 at V = 2, 64x80, D = 12, through ``make_train_step`` with
    a mesh; then ``mesh_view`` 2 (one view a process): the loss identical on both and,
    with every gradient, within the bar of one process's step on the global batch."""
    from multi_view_stereonet_tpu_torch.losses import LossConfig
    from multi_view_stereonet_tpu_torch.train.step import make_loss_fn

    worker = distributed_worker()
    B, V, H, W = 4, 2, 64, 80
    rng = np.random.default_rng(13)
    K, T = scene(B * V, H, W, seed=13)
    depth = rng.uniform(2.0, 10.0, size=(B, H, W)).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < np.array([0.6, 0.05, 0.05, 0.05])[:, None, None]] = 0
    batch = {"left_image": rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32),
             "right_images": rng.uniform(-1, 1, (B, V, H, W, 3)).astype(np.float32),
             "K": K[:B].numpy(), "T_right_in_left": T.reshape(B, V, 4, 4).numpy(),
             "left_depthmap_true": depth}
    np.savez(tmp_path / "batch.npz", **batch)
    torch.save(random_state_dict(0), tmp_path / "weights.pth")
    case = {"weights": str(tmp_path / "weights.pth"), "batch": str(tmp_path / "batch.npz"),
            "two_view": False, "D": 12, "factors": {}}
    job = {"mode": "step", "device": "cuda", "out": str(tmp_path),
           "cases": {"data": dict(case, mesh_view=1), "view": dict(case, mesh_view=2)}}
    results = worker.wait(worker.start(job, str(tmp_path), "card"))
    for rc, out, err in results:
        assert rc == 0 and "RESULT ok" in out, err[-3000:]
    assert "2 processes over gloo" in results[0][1]

    model = MultiViewStereoNet()
    model.load_state_dict(random_state_dict(0))
    model = model.to(dev)
    loss, _ = make_loss_fn(MultiViewStereoNetConfig(num_idepth_samples=12), LossConfig())(
        model, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
    loss.backward()
    ref = (loss.item(), {k: p.grad for k, p in model.named_parameters()})
    for name in ("data", "view"):
        r0, r1 = (np.load(tmp_path / f"{name}_rank{r}.npz") for r in (0, 1))
        assert r0["loss"] == r1["loss"], name
        got = {k: torch.from_numpy(r0[f"grad/{k}"]).to(dev) for k in ref[1]}
        assert_training_matches_plain({"auto": (float(r0["loss"]), got), "plain": ref})


def test_kernels_launch_on_their_tensors_card_when_another_is_current(dev):
    """With card 0 current, each kernel on tensors of card 1 launches there and matches
    its plain version (the wrappers make the tensors' card current for the launch)."""
    if torch.cuda.device_count() < 2:
        pytest.skip(f"needs two cards, this machine has {torch.cuda.device_count()}")
    other = torch.device("cuda", 1)
    g = torch.Generator().manual_seed(3)
    image = (torch.rand(2, 64, 80, 3, generator=g) * 2 - 1).to(other)
    grid = (torch.rand(2, 64, 80, 2, generator=g) * 2.2 - 1.1).to(other)
    module = idepthmap_refiner_module(35, seed=1, dev=other)
    guidance = (torch.rand(2, 35, 30, 40, generator=g) * 2 - 1).to(other)
    idepth = (torch.rand(2, 30, 40, generator=g) * 20).to(other)
    x, weight, bias, res = gn_case((2, 32, 30, 40), True, other)
    refiner, feats0, image_rest, H_inc = chain_case(2, 30, 40, 12, 0.0, seed=2, dev=other)
    calls = {
        "K1": lambda impl: warp.grid_sample(image, grid, True, impl=impl)[0],
        "K2": lambda impl: chain.incremental_chain(refiner, feats0, image_rest, H_inc,
                                                   impl=impl),
        "K3": lambda impl: refiner_op.idepthmap_refiner(module, guidance, idepth, impl),
        "K4": lambda impl: gn_apply.group_norm_act(x, weight, bias, 4, res, impl),
    }
    with torch.cuda.device(0), torch.inference_mode():
        for name, call in calls.items():
            before = counts()
            got = call("auto")
            assert counts() != before, name  # the kernel, not the plain version
            ref = call("plain")
            torch.cuda.synchronize(other)
            assert got.device == other and torch.cuda.current_device() == 0, name
            assert torch.allclose(got, ref, atol=2e-5 * max(1.0, ref.abs().max().item()),
                                  rtol=2e-4), name


def rendered_pair(B=1, seed=11, rows=64, cols=80):
    """A two-view batch (numpy, ``unpack_batch``'s keys), the scene of
    ``tests/test_grad_parity.py``'s two-view case: a textured plane tilted by the normal
    (0.35, 0.25, 1) at depth 8 seen from the left camera and from one 0.4 to the right
    (0.03 down), images in [-1, 1], ~10% of each truth depthmap invalid (0). Sample b is
    rendered from seed + b."""
    data = synthetic_data()
    samples = []
    for b in range(B):
        rng = np.random.default_rng(seed + b)
        K3 = data._camera(rows, cols)
        K3[0, 2] -= 0.5
        K3[1, 2] -= 0.5
        texture = data._smooth_texture(rng, rows, cols)
        T_right = np.eye(4)
        T_right[0, 3], T_right[1, 3] = 0.4, 0.03
        K = np.eye(4, dtype=np.float32)
        K[:3, :3] = K3
        sample = {"K": K, "T_right_in_left": T_right.astype(np.float32)}
        for side, T in (("left", np.eye(4)), ("right", T_right)):
            image, depth = data._render_view(texture, K3, K3, rows, cols, T, 8.0,
                                             plane_normal=(0.35, 0.25, 1.0))
            depth = depth.astype(np.float32)
            depth[rng.uniform(size=depth.shape) < 0.1] = 0.0
            sample[f"{side}_image"] = image.astype(np.float32) / 127.5 - 1.0
            sample[f"{side}_depthmap_true"] = depth
        samples.append(sample)
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def test_two_view_loss_kernels_match_plain_and_the_backward_launches_nothing(dev):
    """The two-view recipe with every loss branch (supervision 1, left-right and
    reconstruction 0.5) at 64x80, B = 2, D = 12, on a rendered pair, kernel path against
    ``impl="plain"`` from the same weights: the loss and gradients as above; K1 launches
    2 a forward and 42 in the losses (occlusion 12, left-right 20, reconstruction 10),
    the rest 1 / 4 / 17 a forward; the backward no forward kernel, K1's backward kernel 20
    times (the left-right loss's two idepth samples a level and the reconstruction's two;
    the occlusion samples feed comparisons alone) and K2's backward twice (two launches
    each)."""
    from multi_view_stereonet_tpu_torch.losses import LossConfig
    from multi_view_stereonet_tpu_torch.train.step import make_loss_fn

    model = MultiViewStereoNet()
    model.load_state_dict(random_state_dict(0))
    model = model.to(dev)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in rendered_pair(2).items()}
    config = MultiViewStereoNetConfig(num_idepth_samples=12)
    losses = LossConfig(supervision_factor=1.0, left_right_factor=0.5,
                        reconstruction_factor=0.5)
    results = {}
    for impl in ("auto", "plain"):
        model.zero_grad(set_to_none=True)
        before = counts()
        loss, loss_dict = make_loss_fn(config, losses, multi_view=False,
                                       estimate_right_idepthmap=True, impl=impl)(model, batch)
        forward = tuple(a - b for a, b in zip(counts(), before))
        bwd_before = backward_counts()
        loss.backward()
        torch.cuda.synchronize()
        backward = tuple(a - b for a, b in zip(counts(), before))
        assert forward == backward == ((2 * 2 + 42, 2, 8, 34) if impl == "auto"
                                       else (0, 0, 0, 0))
        assert tuple(a - b for a, b in zip(backward_counts(), bwd_before))[:2] == (
            (20, 4) if impl == "auto" else (0, 0))
        assert loss_dict["left_right_loss"].item() > 0
        results[impl] = (loss.item(), {k: p.grad.clone() for k, p in model.named_parameters()})
    assert_training_matches_plain(results)


def test_serving_forward_never_synchronizes(dev):
    """On a batch already on the card, the forward queues work and never
    waits for the device (no host copies, no .item())."""
    from multi_view_stereonet_tpu_torch.eval.streaming import serving_forward

    model = MultiViewStereoNet()
    model.load_state_dict(random_state_dict(0))
    model = model.to(dev).eval()
    g = torch.Generator().manual_seed(3)
    K, T = scene(2, 64, 80, seed=4)
    batch = {"left_image": torch.rand(1, 64, 80, 3, generator=g).to(dev),
             "right_images": torch.rand(1, 2, 64, 80, 3, generator=g).to(dev),
             "K": K[:1].to(dev), "T_right_in_left": T.reshape(1, 2, 4, 4).to(dev)}
    config = MultiViewStereoNetConfig(num_idepth_samples=12)
    with torch.inference_mode():
        serving_forward(model, batch, config)  # builds and caches the resize matrices
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = serving_forward(model, batch, config)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert out.shape == (1, 64, 80) and torch.isfinite(out).all()


def test_plain_paths_launch_nothing(dev):
    """impl='plain' on the card: the chain's plain loop (whose refiner owns a
    resblock), the refiners and the cost filter run no kernel."""
    prefix = "right_feature_extractor.refiner."
    feature_refiner = FeatureRefiner(32)
    feature_refiner.load_state_dict({k[len(prefix):]: v for k, v in
                                     random_state_dict(0).items() if k.startswith(prefix)})
    feature_refiner = feature_refiner.to(dev).eval()
    K, T = scene(1, 30, 40, seed=5)
    samples = create_idepth_samples(T, K, 30, 40, 4)
    H_inc = incremental_homographies(create_plane_sweep_homographies(T, K, samples)).to(dev)
    module = idepthmap_refiner_module(35, seed=0, dev=dev)
    with torch.inference_mode():
        before = counts()
        chain.incremental_chain(feature_refiner, torch.randn(1, 30, 40, 32, device=dev),
                                torch.rand(1, 3, 30, 40, 3, device=dev), H_inc, impl="plain")
        chain.incremental_chain_plain(feature_refiner, torch.randn(1, 30, 40, 32, device=dev),
                                      torch.rand(1, 3, 30, 40, 3, device=dev), H_inc)
        refiner_op.idepthmap_refiner(module, torch.rand(1, 35, 30, 40, device=dev),
                                     torch.rand(1, 30, 40, device=dev), impl="plain")
        module(torch.rand(1, 35, 120, 160, device=dev), torch.rand(1, 120, 160, device=dev),
               impl="plain")
        CostVolumeFilter(32).to(dev)(torch.rand(1, 32, 4, 30, 40, device=dev), impl="plain")
    torch.cuda.synchronize()
    assert counts() == before


def assert_grads_match_plain(fn, inputs, bar=1e-5):
    """The kernel path's gradients (its Function's backward kernel) equal plain
    autograd's within ``bar`` * max(1, max|plain|), and the backward launches no forward
    kernel."""
    g = torch.Generator().manual_seed(9)
    outs = {impl: fn(impl) for impl in ("kernel", "plain")}
    cot = torch.randn(outs["plain"].shape, generator=g).to(outs["plain"].device)
    assert outs["kernel"].grad_fn is not None
    before = counts()
    grads = {impl: torch.autograd.grad((out * cot).sum(), inputs)
             for impl, out in outs.items()}
    torch.cuda.synchronize()
    assert counts() == before
    for got, ref in zip(grads["kernel"], grads["plain"]):
        tol = bar * max(1.0, ref.abs().max().item())
        torch.testing.assert_close(got, ref, atol=tol, rtol=0)


def test_kernels_refuse_what_they_do_not_take(dev):
    """And, for a tensor that requires grad, give plain autograd's gradients through
    their backward kernels."""
    g = torch.Generator().manual_seed(8)
    image = (torch.rand(1, 4, 5, 3, generator=g) * 2 - 1).to(dev).requires_grad_()
    grid = (torch.rand(1, 4, 5, 2, generator=g) * 2.2 - 1.1).to(dev).requires_grad_()
    assert_grads_match_plain(lambda impl: warp.grid_sample(image, grid, True, impl)[0],
                             [image, grid])
    with pytest.raises(TypeError, match="float32"):
        warp.grid_sample(image.detach().double(), grid)

    x = torch.randn(1, 32, 4, 8, generator=g).to(dev).requires_grad_()
    r = torch.randn(1, 32, 4, 8, generator=g).to(dev).requires_grad_()
    w = (1 + 0.1 * torch.randn(32, generator=g)).to(dev).requires_grad_()
    b = (0.1 * torch.randn(32, generator=g)).to(dev).requires_grad_()
    assert_grads_match_plain(lambda impl: gn_apply.gn_apply_residual(x, r, w, b, 4, impl),
                             [x, r, w, b])
    with pytest.raises(TypeError, match="float32"):
        gn_apply.gn_apply_residual(x.detach().double(), x.detach().double(), w, b, 4)
    with pytest.raises(ValueError, match="bad shapes"):
        gn_apply.gn_apply_residual(x.detach(), x.detach()[:, :16], w, b, 4)

    module = idepthmap_refiner_module(35, seed=0, dev=dev)
    guidance = (torch.rand(1, 35, 6, 8, generator=g) * 2 - 1).to(dev).requires_grad_()
    idepth = (torch.rand(1, 6, 8, generator=g) * 20).to(dev).requires_grad_()
    assert_grads_match_plain(
        lambda impl: refiner_op.idepthmap_refiner(module, guidance, idepth, impl),
        [guidance, idepth, *module.parameters()])
    with pytest.raises(TypeError, match="float32"):
        refiner_op.idepthmap_refiner(module.double(), guidance.detach().double(),
                                     idepth.detach().double())
    with pytest.raises(ValueError, match="bad shapes"):
        refiner_op.idepthmap_refiner(idepthmap_refiner_module(35, seed=0, dev=dev),
                                     guidance.detach()[:, :3], idepth.detach())
    # A dilation wider than the kernel's staged halo (8) is refused at launch.
    wide = idepthmap_refiner_module(35, seed=0, dev=dev)
    wide.res3.conv1.dilation, wide.res3.conv1.padding = (16, 16), (16, 16)
    before = refiner_op.launches
    with torch.inference_mode(), pytest.raises(RuntimeError, match="failed to launch"):
        refiner_op.idepthmap_refiner(wide, guidance.detach(), idepth.detach())
    assert refiner_op.launches == before


def _op_case(name, dev):
    """Arguments of one custom op at a small shape, on the card."""
    g = torch.Generator().manual_seed(11)

    def rand(*shape):
        return (torch.rand(shape, generator=g) * 2 - 1).to(dev)
    if name == "grid_sample":
        return rand(2, 6, 8, 3), rand(2, 4, 5, 7, 2) * 1.2, True
    if name == "group_norm_act":
        x = rand(2, 32, 5, 6)
        return x, rand(32) + 1, rand(32), rand(2, 32, 5, 6), 4
    if name == "incremental_chain":
        refiner = FeatureRefiner(32).to(dev)
        res = refiner.res0
        vec = torch.stack([refiner.conv0.bias, refiner.bn0.weight, refiner.bn0.bias,
                           res.conv1.bias, res.bn1.weight, res.bn1.bias,
                           refiner.conv_final.bias]).detach()
        taps = [chain._taps(w).detach() for w in (refiner.conv0.weight, res.conv1.weight,
                                                  refiner.conv_final.weight)]
        H_inc = torch.eye(3, device=dev).repeat(1, 3, 1, 1)
        return (rand(1, 5, 6, 32), rand(1, 3, 5, 6, 3), H_inc, *taps, vec, 0)
    module = idepthmap_refiner_module(35, seed=1, dev=dev)
    pack, dilations = refiner_op.packed_weights(module)
    return rand(2, 35, 6, 8), rand(2, 6, 8).abs() * 20, pack, list(dilations)


@pytest.mark.parametrize("name", ["grid_sample", "incremental_chain", "idepthmap_refiner",
                                  "group_norm_act"])
def test_custom_ops_pass_opcheck_on_the_card(dev, name):
    """Schema, fake implementation against the kernel's real outputs, and tracing."""
    torch.library.opcheck(getattr(torch.ops.mvs_torch, name).default, _op_case(name, dev))


def test_export_on_the_card_holds_the_four_kernels_and_serves_the_live_bits(dev, tmp_path):
    """B = 1, V = 1, 64x80, D = 12: the artifact exported on the card holds the four
    custom ops, launches 2 / 1 / 4 / 17 a forward (K3 at levels 4..1 at this size) and
    is bit-equal to the live forward, which is bit-equal before and after the export."""
    from multi_view_stereonet_tpu_torch.checkpoint.export import (
        custom_ops, export_inference, load_exported, save_exported)
    from multi_view_stereonet_tpu_torch.eval.streaming import serving_forward

    model = MultiViewStereoNet()
    model.load_state_dict(random_state_dict(0))
    model = model.to(dev).eval()
    config = MultiViewStereoNetConfig(num_idepth_samples=12)
    g = torch.Generator().manual_seed(3)
    K, T = scene(1, 64, 80, seed=4)
    args = ((torch.rand(1, 64, 80, 3, generator=g) * 2 - 1).to(dev),
            (torch.rand(1, 1, 64, 80, 3, generator=g) * 2 - 1).to(dev), K.to(dev),
            T.reshape(1, 1, 4, 4).to(dev))
    batch = dict(zip(("left_image", "right_images", "K", "T_right_in_left"), args))
    with torch.inference_mode():
        live = serving_forward(model, batch, config)
    path = str(tmp_path / "serving.pt2")
    save_exported(export_inference(model, config, 1, 1, (64, 80)), path)
    artifact = load_exported(path)
    assert custom_ops(artifact) == ["mvs_torch::grid_sample", "mvs_torch::group_norm_act",
                                    "mvs_torch::idepthmap_refiner",
                                    "mvs_torch::incremental_chain"]
    with torch.inference_mode():
        before = counts()
        out = artifact(*args)
        assert counts() == tuple(b + d for b, d in zip(before, (2, 1, 4, 17)))
        again = serving_forward(model, batch, config)
    assert torch.isfinite(live).all()
    assert torch.equal(out, live) and torch.equal(again, live)


def synthetic_data():
    """tests/synthetic_data.py by path: an installed package named ``tests`` may shadow
    this directory."""
    spec = importlib.util.spec_from_file_location(
        "synthetic_data", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                       "synthetic_data.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def small_run(tmp_path):
    """A 64x80 GTA-SfM tree (three requests) and a run dir with seeded weights."""
    from multi_view_stereonet_tpu_torch.eval.streaming import WEIGHTS_FILE

    data_dir, split = synthetic_data().make_gta_sfm_tree(
        str(tmp_path / "gta"), num_sequences=1, frames=4, rows=64, cols=80)
    weights_dir = tmp_path / "run" / "checkpoints" / "epoch0000"
    weights_dir.mkdir(parents=True)
    (tmp_path / "run" / "params.yaml").write_text(yaml.safe_dump(
        {"size": [64, 80], "num_idepth_samples": 4}))
    torch.save(random_state_dict(3), str(weights_dir / WEIGHTS_FILE))
    return str(weights_dir), data_dir, split


def test_eval_cli_on_the_card_writes_a_device_trace(dev, small_run, tmp_path):
    """run_eval with no device runs on the card, through the kernels, and
    ``--profile_dir`` writes a Chrome trace that holds the card's kernels."""
    from multi_view_stereonet_tpu_torch.eval.test_cli import run_eval

    weights_dir, data_dir, split = small_run
    before = counts()
    loss, avg = run_eval(weights_dir, data_dir, split, str(tmp_path / "out"), batch_size=2,
                         decode_backend="pil", profile_dir=str(tmp_path / "trace"))
    assert np.isfinite(loss) and avg["num_samples"] == 3
    assert all(after > b for after, b in zip(counts(), before))
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    assert any("refiner_kernel" in n for n in names), sorted(names)[:20]


def test_streaming_cli_on_the_card_over_the_u8_transport(dev, small_run, capsys):
    from multi_view_stereonet_tpu_torch.eval.streaming import main

    weights_dir, data_dir, split = small_run
    served = []
    for shard_id in (0, 1):
        main([weights_dir, data_dir, split, "--batch_size", "2", "--workers", "1",
              "--decode_backend", "pil", "--transfer_u8", "--fetch_f16",
              "--shard_id", str(shard_id), "--num_shards", "2"])
        out = capsys.readouterr().out
        assert torch.cuda.get_device_name(0) in out
        served.append(int(out.split()[0]))
    assert served == [2, 1]


def test_runner_on_the_card_yields_copies_out_of_a_pinned_ring(dev, small_run, monkeypatch):
    """One step in flight: three batches read back through two pinned buffers, the
    third rewriting the first's. The arrays yielded are copies that own their memory
    and equal the forward's output read back alone."""
    from multi_view_stereonet_tpu_torch.eval import streaming
    from multi_view_stereonet_tpu_torch.train.config import load_params_yaml

    weights_dir, data_dir, split = small_run
    cfg = load_params_yaml(os.path.join(weights_dir, "..", "..", "params.yaml"))
    runner = streaming.StreamingRunner(streaming.load_model(weights_dir, dev),
                                       streaming.model_config_from_params(cfg))
    dataset = streaming.make_dataset(data_dir, split, cfg, decode_backend="pil")
    taken = []
    take = streaming.ReadbackRing.take

    def recording_take(self, step, shape, dtype):
        buf = take(self, step, shape, dtype)
        taken.append(buf)
        return buf

    monkeypatch.setattr(streaming.ReadbackRing, "take", recording_take)
    monkeypatch.setattr(streaming, "IN_FLIGHT", 1)
    served = list(runner.run(dataset, batch_size=1, workers=1))
    assert len(served) == len(taken) == 3
    assert all(buf.is_pinned() for buf in taken)
    assert taken[2].data_ptr() == taken[0].data_ptr() != taken[1].data_ptr()
    for i, (idepth, names) in enumerate(served):
        assert type(idepth) is np.ndarray and idepth.flags.owndata
        sample = dataset[i]
        batch = {"left_image": sample["left_image"][None], "K": sample["K"][None],
                 "right_images": np.stack(sample["right_images"])[None],
                 "T_right_in_left": np.stack(sample["T_right_in_left"])[None]}
        np.testing.assert_array_equal(idepth, runner.forward(batch).cpu().numpy())


def serve_replicas(runner, dataset, batch_size):
    """(depthmaps in sample order, names, launches of each kernel in the run)."""
    before = counts()
    served = list(runner.run(dataset, batch_size=batch_size, workers=1))
    launched = tuple(a - b for a, b in zip(counts(), before))
    return (np.concatenate([d for d, _ in served]), [n for _, ns in served for n in ns],
            launched)


def replica_runs(small_run, devices, u8):
    """One replica on ``devices[0]`` at batch 1, and one replica a device at batch 2: the
    same forwards of one request over the three-request tree (1, 1, then the tail's 1
    on replica 0)."""
    from multi_view_stereonet_tpu_torch.eval import streaming
    from multi_view_stereonet_tpu_torch.train.config import load_params_yaml

    weights_dir, data_dir, split = small_run
    cfg = load_params_yaml(os.path.join(weights_dir, "..", "..", "params.yaml"))
    config = streaming.model_config_from_params(cfg)
    model = streaming.load_model(weights_dir, devices[0])
    dataset = streaming.make_dataset(data_dir, split, cfg, decode_backend="pil",
                                     u8_output=u8)
    one = serve_replicas(streaming.StreamingRunner(model, config, device=devices[0]),
                         dataset, 1)
    runner = streaming.StreamingRunner(model, config, devices=devices)
    return one, serve_replicas(runner, dataset, 2), runner, dataset


@pytest.mark.parametrize("u8", [False, True])
def test_two_replicas_on_one_card_are_bit_equal_to_one(dev, small_run, u8):
    """The card named twice: two replicas, each on a stream of its own with a K3 barrier
    counter of its own, bit-equal to one replica at the same per-forward batches over the
    f32 and u8 transports, launching what its forwards launch."""
    flag = torch.backends.cudnn.allow_tf32
    one, two, runner, _ = replica_runs(small_run, [dev, dev], u8)
    np.testing.assert_array_equal(two[0].view(np.int32), one[0].view(np.int32))
    assert two[1] == one[1] and two[2] == one[2] and all(n > 0 for n in two[2])
    streams = [r.stream for r in runner._replicas]
    assert None not in streams and streams[0] != streams[1]
    index = torch.cuda.current_device()
    assert {(index, s.cuda_stream) for s in streams} <= set(build._barriers)
    assert torch.backends.cudnn.allow_tf32 is flag


def test_replicas_on_two_cards_are_bit_equal_to_one_card(dev, small_run):
    """One replica on each of two cards against one on card 0 at the same per-forward
    batches, bit for bit; the second card's K3 ran on its own barrier counter, and a
    runner on card 1 alone, with card 0 current, reads back what card 0 serves."""
    if torch.cuda.device_count() < 2:
        pytest.skip(f"needs two cards, this machine has {torch.cuda.device_count()}")
    from multi_view_stereonet_tpu_torch.eval import streaming

    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    one, two, runner, dataset = replica_runs(small_run, cards, u8=False)
    np.testing.assert_array_equal(two[0].view(np.int32), one[0].view(np.int32))
    assert two[1] == one[1] and two[2] == one[2]
    assert (1, runner._replicas[1].stream.cuda_stream) in build._barriers
    model = streaming.load_model(small_run[0], "cpu")
    with torch.cuda.device(0):
        alone = serve_replicas(streaming.StreamingRunner(model, runner.model_config,
                                                         device=cards[1]), dataset, 1)
    np.testing.assert_array_equal(alone[0].view(np.int32), one[0].view(np.int32))


# ---- the bf16 kernels (compute_dtype bfloat16) ----

BF16 = torch.bfloat16


def bf16_ulp(t):
    mag = t.abs().clamp_min(torch.finfo(BF16).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def test_bf16_grid_sample_is_the_f32_kernel_rounded(dev):
    g = torch.Generator().manual_seed(3)
    image = (torch.rand(2, 64, 80, 3, generator=g) * 2 - 1).to(dev)
    grid = (torch.rand(2, 64, 80, 2, generator=g) * 2.2 - 1.1).to(dev)
    before = warp.launches
    got, inv = warp.grid_sample(image, grid, True, out_dtype=BF16)
    f32, inv32 = warp.grid_sample(image, grid, True)
    assert warp.launches == before + 2
    assert got.dtype == BF16 and torch.equal(got, f32.to(BF16)) and torch.equal(inv, inv32)
    with pytest.raises(TypeError, match="float32"):
        warp.grid_sample(image.to(BF16), grid, impl="kernel")


@pytest.mark.parametrize("shape,residual", [((2, 32, 30, 40), True), ((1, 32, 96, 128), True),
                                            ((1, 32, 96, 128), False),
                                            ((2, 32, 12, 30, 40), False)])
def test_bf16_gn_kernel_within_a_rounding_of_plain(dev, shape, residual):
    """Within one bf16 ulp of the f32 GroupNorm value and one of the plain result at
    each element (the rounding of the GroupNorm value is the one that can differ), with
    a conv bias given to the GroupNorm (xbias)."""
    g = torch.Generator().manual_seed(len(shape))
    x = (torch.randn(shape, generator=g) * 2 + 0.5).to(dev).to(BF16)
    res = torch.randn(shape, generator=g).to(dev).to(BF16) if residual else None
    weight = (1 + 0.1 * torch.randn(32, generator=g)).to(dev)
    bias = (0.1 * torch.randn(32, generator=g)).to(dev)
    xbias = (0.3 * torch.randn(32, generator=g)).to(dev)
    before = gn_apply.launches
    got = gn_apply.group_norm_act(x, weight, bias, 4, res, xbias=xbias).float()
    ref = gn_apply.group_norm_act(x, weight, bias, 4, res, impl="plain", xbias=xbias).float()
    assert gn_apply.launches == before + 1
    y = torch.nn.functional.group_norm(
        x.float() + xbias.reshape((-1,) + (1,) * (x.ndim - 2)), 4, weight, bias, 1e-5)
    assert torch.all((got - ref).abs() <= bf16_ulp(y) + bf16_ulp(ref))
    assert (got == ref).float().mean().item() > 0.999


@pytest.mark.parametrize("n,d", [(1, 12), (8, 12), (2, 2)])
def test_bf16_chain_kernel_against_plain_and_f32(dev, n, d):
    """Within 5% of max|plain| of the plain loop at bf16 (the scan's bf16 warp against
    the kernel's f32 one, compounded over the steps) and within 2% of the f32 chain."""
    refiner, feats0, image_rest, H_inc = chain_case(n, 30, 40, d, 0.0, seed=n + d, dev=dev)
    with torch.inference_mode():
        before = chain.launches
        got = chain.incremental_chain(refiner, feats0.to(BF16), image_rest, H_inc)
        ref = chain.incremental_chain(refiner, feats0.to(BF16), image_rest, H_inc,
                                      impl="plain").float()
        ref32 = chain.incremental_chain(refiner, feats0.to(BF16).float(), image_rest, H_inc,
                                        impl="plain")
    assert chain.launches == before + 1
    assert got.dtype == BF16 and got.shape == (n, d, 30, 40, 32)
    got = got.float()
    assert (got - ref).abs().max().item() <= 5e-2 * ref.abs().max().item()
    assert (got - ref32).abs().max().item() <= 2e-2 * ref32.abs().max().item()


@pytest.mark.parametrize("n,h,w", [(1, 30, 40), (2, 30, 40), (1, 60, 80)])
def test_bf16_refiner_kernel_matches_plain(dev, n, h, w):
    module = idepthmap_refiner_module(35, seed=n, dev=dev)
    g = torch.Generator().manual_seed(h)
    guidance = (torch.rand(n, 35, h, w, generator=g) * 2 - 1).to(dev).to(BF16)
    idepth = (torch.rand(n, h, w, generator=g) * 20).to(dev)
    with torch.inference_mode():
        before = refiner_op.launches
        got = refiner_op.idepthmap_refiner(module, guidance, idepth)
        ref = refiner_op.idepthmap_refiner(module, guidance, idepth, impl="plain")
    assert refiner_op.launches == before + 1
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert (got - ref).abs().max().item() <= 1e-2 * ref.abs().max().item()
    assert (ref - torch.relu(idepth)).abs().mean().item() > 0.01


def test_bf16_pack_is_not_served_to_the_f32_kernel(dev):
    """After a bf16 launch, an f32 launch gets the f32 pack: its output is the one an
    f32 launch gives from a cold cache, and differs from the bf16 launch's."""
    module = idepthmap_refiner_module(35, seed=5, dev=dev)
    g = torch.Generator().manual_seed(5)
    guidance = (torch.rand(1, 35, 30, 40, generator=g) * 2 - 1).to(dev)
    idepth = (torch.rand(1, 30, 40, generator=g) * 20).to(dev)
    with torch.inference_mode():
        refiner_op.invalidate_packed_weights(module)
        cold = refiner_op.idepthmap_refiner(module, guidance, idepth)
        low = refiner_op.idepthmap_refiner(module, guidance.to(BF16), idepth)
        after = refiner_op.idepthmap_refiner(module, guidance, idepth)
    assert torch.equal(after, cold) and not torch.equal(low, cold)


def test_bf16_forward_launches_each_kernel_at_bf16(dev):
    """The bf16 forward launches K1-K4 (the f32 forward's counts at 64x80), no cast back
    to f32 on the way: its outputs are f32 and within 3% of the f32 forward's range."""
    model = MultiViewStereoNet()
    model.load_state_dict(random_state_dict(0))
    model = model.to(dev).eval()
    g = torch.Generator().manual_seed(1)
    B, V, H, W = 1, 2, 64, 80
    left = (torch.rand(B, H, W, 3, generator=g) * 2 - 1).to(dev)
    rights = (torch.rand(B * V, H, W, 3, generator=g) * 2 - 1).to(dev)
    K, T = scene(B * V, H, W, seed=2)
    left_pyr = build_image_pyramid(left, 5)
    right_pyrs = [r.reshape(B, V, *r.shape[1:]) for r in build_image_pyramid(rights, 5)]
    K_pyr = build_K_pyramid(K[:B].to(dev), [(p.shape[1], p.shape[2]) for p in left_pyr])
    T = T.reshape(B, V, 4, 4).to(dev)
    config = MultiViewStereoNetConfig(num_idepth_samples=12, compute_dtype="bfloat16")
    with torch.inference_mode():
        before = counts()
        got = mvsnet_forward(model, left_pyr, K_pyr, T, right_pyrs, config)
        assert counts() == tuple(b + d for b, d in zip(before, (2, 1, 4, 17)))
        ref = mvsnet_forward(model, left_pyr, K_pyr, T, right_pyrs,
                             MultiViewStereoNetConfig(num_idepth_samples=12))
    for lvl in range(5):
        a, b = got["left_idepthmap_pyr"][lvl], ref["left_idepthmap_pyr"][lvl]
        span = (b.max() - b.min()).item()
        assert a.dtype == torch.float32 and torch.isfinite(a).all() and span > 0
        assert (a - b).abs().max().item() <= 3e-2 * span

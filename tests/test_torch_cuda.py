"""The port's CUDA kernels against their plain versions, on an NVIDIA card.

Every test here is marked ``cuda`` and skips without a card. The file
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Bars, with TF32 off: the grid sample within 1e-5 abs and equal invalid
masks (bit-equal at the losses' shapes, NaN where the plain version has NaN; its
backward within 1e-4 of max|plain autograd|); the incremental chain (at the serving shapes and at N = 8, one step,
a 4x5 and a 48x64 map, a pose with many invalid samples) and the idepthmap
refiner within atol 2e-5 * max|plain|, rtol 2e-4, also after its weights are written
(its packed weights followed); the GroupNorm kernel within 1e-5 * max(1, max|plain|);
the whole forward within 0.2% of each level's output range; the multi-view and
the two-view training losses and gradients within docs/PARITY.md:218-232's bar. The u8 dequantize is
bit-equal to the host pipeline for all 256 values. Each kernel's custom op passes
``torch.library.opcheck``, and the serving artifact exported on the card holds all
four and is bit-equal to the live forward.
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
    incremental_homographies, normalize_baseline)
from multi_view_stereonet_tpu_torch.models import (
    CostVolumeFilter, FeatureRefiner, IDepthmapRefiner, MultiViewStereoNet,
    MultiViewStereoNetConfig, mvsnet_forward)
from multi_view_stereonet_tpu_torch.ops import build_image_pyramid, homography_grid
from multi_view_stereonet_tpu_torch.ops.cuda import gn_apply
from multi_view_stereonet_tpu_torch.ops.cuda import incremental_chain as chain
from multi_view_stereonet_tpu_torch.ops.cuda import refiner as refiner_op
from multi_view_stereonet_tpu_torch.ops.cuda import warp

REFINER_ATOL, REFINER_RTOL = 2e-5, 2e-4
GN_BAR = 1e-5


def counts():
    return (warp.launches, chain.launches, refiner_op.launches, gn_apply.launches)

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


def test_gn_launch_error_raises(dev):
    """A launch the card refuses (more than 65535 (sample, group) rows in the grid's y
    dimension) raises; it never runs the plain version instead, and leaves no error
    behind for the next launch."""
    x, weight, bias, res = gn_case((1, 32, 120, 160), True, dev)
    before = gn_apply.launches
    with pytest.raises(RuntimeError, match="failed to launch"):
        gn_apply.group_norm_act_kernel(torch.zeros(16400, 32, 2, 2, device=dev), weight,
                                       bias, 4)
    assert gn_apply.launches == before
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
    The forward launches 2 / 1 / 4 / 17, the backward nothing."""
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
        loss.backward()
        torch.cuda.synchronize()
        backward = tuple(a - b for a, b in zip(counts(), before))
        assert forward == backward == ((2, 1, 4, 17) if impl == "auto" else (0, 0, 0, 0))
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
    the rest 1 / 4 / 17 a forward, the backward nothing."""
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
        loss.backward()
        torch.cuda.synchronize()
        backward = tuple(a - b for a, b in zip(counts(), before))
        assert forward == backward == ((2 * 2 + 42, 2, 8, 34) if impl == "auto"
                                       else (0, 0, 0, 0))
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
    """The kernel path's gradients (its Function's backward, a recompute of the plain
    version) equal plain autograd's within ``bar`` * max(1, max|plain|), and the
    backward launches no kernel."""
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
    """And, for a tensor that requires grad, take the backward through the plain
    version (once the forward only and raised)."""
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

"""The port's CUDA kernels against their plain versions, on an NVIDIA card.

Every test here is marked ``cuda`` and skips without a card. The file
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Bars, with TF32 off: the grid sample within 1e-5 abs and equal invalid
masks; the incremental chain (at the serving shapes and at N = 8, one step,
a 4x5 and a 48x64 map, a pose with many invalid samples) and the idepthmap
refiner within atol 2e-5 * max|plain|, rtol 2e-4; the GroupNorm kernel within
1e-5 * max(1, max|plain|); the whole forward within 0.2% of each level's output range.
"""

import numpy as np
import pytest
import torch

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


def test_kernels_refuse_what_they_do_not_take(dev):
    image = torch.zeros(1, 4, 5, 3, device=dev, requires_grad=True)
    grid = torch.zeros(1, 4, 5, 2, device=dev)
    with pytest.raises(NotImplementedError, match="forward only"):
        warp.grid_sample(image, grid)
    with pytest.raises(TypeError, match="float32"):
        warp.grid_sample(image.detach().double(), grid)

    x = torch.zeros(1, 32, 4, 8, device=dev, requires_grad=True)
    w, b = torch.ones(32, device=dev), torch.zeros(32, device=dev)
    with pytest.raises(NotImplementedError, match="forward only"):
        gn_apply.gn_apply_residual(x, x, w, b, 4)
    with pytest.raises(TypeError, match="float32"):
        gn_apply.gn_apply_residual(x.detach().double(), x.detach().double(), w, b, 4)
    with pytest.raises(ValueError, match="bad shapes"):
        gn_apply.gn_apply_residual(x.detach(), x.detach()[:, :16], w, b, 4)

    module = idepthmap_refiner_module(35, seed=0, dev=dev)
    guidance = torch.zeros(1, 35, 6, 8, device=dev, requires_grad=True)
    idepth = torch.zeros(1, 6, 8, device=dev)
    with pytest.raises(NotImplementedError, match="forward only"):
        refiner_op.idepthmap_refiner(module, guidance, idepth)
    with pytest.raises(TypeError, match="float32"):
        refiner_op.idepthmap_refiner(module.double(), guidance.detach().double(),
                                     idepth.double())
    with pytest.raises(ValueError, match="bad shapes"):
        refiner_op.idepthmap_refiner(idepthmap_refiner_module(35, seed=0, dev=dev),
                                     guidance.detach()[:, :3], idepth)
    # A dilation wider than the kernel's staged halo (8) is refused at launch.
    wide = idepthmap_refiner_module(35, seed=0, dev=dev)
    wide.res3.conv1.dilation, wide.res3.conv1.padding = (16, 16), (16, 16)
    before = refiner_op.launches
    with torch.inference_mode(), pytest.raises(RuntimeError, match="failed to launch"):
        refiner_op.idepthmap_refiner(wide, guidance.detach(), idepth)
    assert refiner_op.launches == before

"""The port's CUDA kernels against their plain versions, on an NVIDIA card.

Every test here is marked ``cuda`` and skips without a card. The file
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Bars, with TF32 off: the grid sample within 1e-5 abs and equal invalid
masks; the incremental chain and the idepthmap refiner within atol
2e-5 * max|plain|, rtol 2e-4; the GroupNorm tail within 1e-5 * max(1,
max|plain|); the whole forward within 0.2% of each level's output range.
"""

import numpy as np
import pytest
import torch

from multi_view_stereonet_tpu_torch.checkpoint import random_state_dict
from multi_view_stereonet_tpu_torch.geometry import (
    build_K_pyramid, create_idepth_samples, create_plane_sweep_homographies,
    incremental_homographies, normalize_baseline)
from multi_view_stereonet_tpu_torch.models import (
    FeatureRefiner, IDepthmapRefiner, MultiViewStereoNet, MultiViewStereoNetConfig,
    mvsnet_forward)
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


@pytest.mark.parametrize("image_shape,grid_shape", [((2, 64, 80, 3), (2, 64, 80, 2)),
                                                    ((3, 30, 40, 3), (3, 12, 30, 40, 2))])
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


@pytest.mark.parametrize("n", [1, 3])
def test_chain_kernel_matches_plain(dev, n):
    prefix = "right_feature_extractor.refiner."
    refiner = FeatureRefiner(32)
    refiner.load_state_dict({k[len(prefix):]: v for k, v in random_state_dict(n).items()
                             if k.startswith(prefix)})
    refiner = refiner.to(dev).eval()
    K, T = scene(n, 30, 40, seed=n)
    samples = create_idepth_samples(T, K, 30, 40, 12)
    H_inc = incremental_homographies(create_plane_sweep_homographies(T, K, samples)).to(dev)
    g = torch.Generator().manual_seed(n)
    feats0 = torch.randn(n, 30, 40, 32, generator=g).to(dev)
    image_rest = (torch.rand(n, 11, 30, 40, 3, generator=g) * 2 - 1).to(dev)
    with torch.inference_mode():
        before = chain.launches
        got = chain.incremental_chain(refiner, feats0, image_rest, H_inc)
        ref = chain.incremental_chain(refiner, feats0, image_rest, H_inc, impl="plain")
    torch.cuda.synchronize()
    assert chain.launches == before + 1
    assert torch.allclose(got, ref, atol=2e-5 * ref.abs().max().item(), rtol=2e-4)


def idepthmap_refiner_module(cg, seed, dev):
    """A seeded fan-in-scale IDepthmapRefiner: refiner4's weights (cg = 35) or
    refiner0's (cg = 3)."""
    prefix = "refiner4." if cg == 35 else "refiner0."
    module = IDepthmapRefiner(cg)
    module.load_state_dict({k[len(prefix):]: v for k, v in random_state_dict(seed).items()
                            if k.startswith(prefix)})
    return module.to(dev).eval()


# The serving shapes (levels 4 at N = 1, 2 and level 3 at 480x640), the
# image-only refiner, and a map smaller than the dilation-8 taps.
@pytest.mark.parametrize("n,cg,h,w", [(1, 35, 30, 40), (2, 35, 30, 40), (1, 35, 60, 80),
                                      (2, 3, 16, 24), (3, 35, 4, 5)])
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


# The serving shapes (extractor at level 4, refiner levels 2 and 0) and a map
# whose H*W is not a multiple of 4 (the scalar path).
@pytest.mark.parametrize("shape", [(2, 32, 30, 40), (1, 32, 120, 160), (1, 32, 480, 640),
                                   (3, 32, 5, 7)])
def test_gn_apply_kernel_matches_plain(dev, shape):
    g = torch.Generator().manual_seed(shape[2])
    x = (torch.randn(shape, generator=g) * 3 + 1).to(dev)
    res = torch.randn(shape, generator=g).to(dev)
    weight = (torch.rand(shape[1], generator=g) + 0.5).to(dev)
    bias = (torch.randn(shape[1], generator=g) * 0.1).to(dev)
    before = gn_apply.launches
    got = gn_apply.gn_apply_residual(x, res, weight, bias, shape[1] // 8)
    ref = gn_apply.gn_apply_residual(x, res, weight, bias, shape[1] // 8, impl="plain")
    torch.cuda.synchronize()
    assert gn_apply.launches == before + 1
    assert (got - ref).abs().max().item() <= GN_BAR * max(1.0, ref.abs().max().item())


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
        # extractor's six resblocks (one batched call each) and refiner0's six.
        expected = tuple(b + d for b, d in zip(before, (2, 1, 4, 12)))
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
    resblock) and the refiners run no kernel."""
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

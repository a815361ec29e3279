"""The PyTorch port's geometry, resizes and plain warp against the JAX package.

Inputs are drawn with numpy from a seed and fed to both sides; JAX runs on
the CPU (conftest). Bar: max abs error <= 1e-5 * max(1, max|JAX|), i.e.
1e-5 absolute for O(1) values and the same relative bar for values with
pixel or focal-length scale (homographies, projected coordinates).
Invalid masks must be equal except where |g| lies within 1e-6 of 1.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multi_view_stereonet_tpu import geometry as jgeo
from multi_view_stereonet_tpu import ops as jops
from multi_view_stereonet_tpu.ops import warp as jwarp
from multi_view_stereonet_tpu_torch import geometry as tgeo
from multi_view_stereonet_tpu_torch import ops as tops
from multi_view_stereonet_tpu_torch.ops.cuda import incremental_chain as tchain
from multi_view_stereonet_tpu_torch.ops.cuda import warp as tcuda_warp

from tests.test_geometry import random_K, random_pose

TOL = 1e-5


def assert_close(t, j, tol=TOL, what=""):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape, (what, t.shape, j.shape)
    scale = max(1.0, float(np.nanmax(np.abs(j))) if j.size else 1.0)
    np.testing.assert_allclose(t, j, atol=tol * scale, rtol=0, err_msg=what)


def poses(rng, n, scale=0.5):
    return np.stack([random_pose(rng, scale=scale) for _ in range(n)])


def Ks(n, rows=64, cols=80):
    return np.stack([random_K(rows, cols) for _ in range(n)])


@pytest.mark.parametrize("name", ["se3_inverse", "baseline_norm", "normalize_baseline",
                                  "mat3_inverse"])
def test_transforms_match_jax(name):
    rng = np.random.default_rng(0)
    x = poses(rng, 5, scale=0.8)
    if name == "mat3_inverse":
        x = x[:, :3, :3] + rng.normal(scale=0.3, size=(5, 3, 3)).astype(np.float32)
    got = getattr(tgeo, name)(torch.from_numpy(x))
    ref = getattr(jgeo, name)(jnp.asarray(x))
    for g, r in zip(got if isinstance(got, tuple) else (got,),
                    ref if isinstance(ref, tuple) else (ref,)):
        assert_close(g, r, what=name)


def test_K_pyramid_matches_jax():
    K = Ks(2, 65, 81)
    sizes = [(65, 81), (33, 41), (17, 21), (9, 11), (5, 6)]
    for g, r in zip(tgeo.build_K_pyramid(torch.from_numpy(K), sizes),
                    jgeo.build_K_pyramid(jnp.asarray(K), sizes)):
        assert_close(g, r, what="K pyramid")


def test_pixel_grid_and_disparity_to_idepth_match_jax():
    rng = np.random.default_rng(1)
    K, T = Ks(3), poses(rng, 3)
    disp = rng.uniform(0, 11, size=(3, 64, 80)).astype(np.float32)
    assert_close(tgeo.pixel_grid(64, 80), jgeo.pixel_grid(64, 80), what="pixel grid")
    got = tgeo.disparity_to_idepth(torch.from_numpy(K), torch.from_numpy(T),
                                   torch.from_numpy(disp))
    ref = jgeo.disparity_to_idepth(jnp.asarray(K), jnp.asarray(T), jnp.asarray(disp))
    assert_close(got, ref, what="disparity_to_idepth")


def test_degenerate_baseline_stays_finite_and_samples_nan_on_empty():
    """Zero baseline: the masked 0/0 LSQ gives 0 idepth, not NaN; with no
    valid pixel the hypothesis grid is NaN, on both sides."""
    K = Ks(2)
    T = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    disp = np.full((2, 64, 80), 11.0, np.float32)
    got = tgeo.disparity_to_idepth(torch.from_numpy(K), torch.from_numpy(T),
                                   torch.from_numpy(disp))
    ref = jgeo.disparity_to_idepth(jnp.asarray(K), jnp.asarray(T), jnp.asarray(disp))
    assert torch.isfinite(got).all() and np.isfinite(np.asarray(ref)).all()
    assert_close(got, ref)
    got_s = tgeo.create_idepth_samples(torch.from_numpy(T), torch.from_numpy(K), 4, 5, 6)
    ref_s = jgeo.create_idepth_samples(jnp.asarray(T), jnp.asarray(K), 4, 5, 6)
    assert torch.isnan(got_s[:, 1:]).all() and np.isnan(np.asarray(ref_s)[:, 1:]).all()


@pytest.mark.parametrize("D", [4, 12])
def test_idepth_samples_and_homographies_match_jax(D):
    rng = np.random.default_rng(D)
    T, _ = jgeo.normalize_baseline(jnp.asarray(poses(rng, 2, scale=0.8)))
    T = np.array(T)
    K4 = Ks(2, 4, 5)
    got = tgeo.create_idepth_samples(torch.from_numpy(T), torch.from_numpy(K4), 4, 5, D)
    ref = jgeo.create_idepth_samples(jnp.asarray(T), jnp.asarray(K4), 4, 5, D)
    assert_close(got, ref, what="idepth samples")

    samples = np.array(ref)
    H_t = tgeo.create_plane_sweep_homographies(torch.from_numpy(T), torch.from_numpy(K4),
                                               torch.from_numpy(samples))
    H_j = jgeo.create_plane_sweep_homographies(jnp.asarray(T), jnp.asarray(K4),
                                               jnp.asarray(samples))
    assert_close(H_t, H_j, what="plane-sweep homographies")
    assert_close(tgeo.incremental_homographies(H_t), jgeo.incremental_homographies(H_j),
                 what="incremental homographies")
    Tinv = np.array(jgeo.se3_inverse(jnp.asarray(T)))
    assert_close(
        tgeo.get_fronto_parallel_homography(torch.from_numpy(K4[:, :3, :3]),
                                            torch.from_numpy(K4[:, :3, :3]),
                                            torch.from_numpy(Tinv),
                                            torch.from_numpy(samples[:, -1])),
        jgeo.get_fronto_parallel_homography(jnp.asarray(K4[:, :3, :3]),
                                            jnp.asarray(K4[:, :3, :3]), jnp.asarray(Tinv),
                                            jnp.asarray(samples[:, -1])),
        what="fronto-parallel homography")


@pytest.mark.parametrize("shape,out", [((2, 8, 10, 3), (16, 20)),   # 2x up, NHWC
                                       ((2, 9, 11), (17, 21)),      # odd up, NHW
                                       ((1, 64, 80, 3), (30, 41))])  # down
def test_resizes_match_jax(shape, out):
    x = np.random.default_rng(2).uniform(-1, 1, size=shape).astype(np.float32)
    assert_close(tops.resize_bilinear(torch.from_numpy(x), out),
                 jops.resize_bilinear(jnp.asarray(x), out), what="bilinear")
    assert_close(tops.resize_area(torch.from_numpy(x), out),
                 jops.resize_area(jnp.asarray(x), out), what="area")
    mask = x > 0.2
    np.testing.assert_array_equal(tops.upsample_mask(torch.from_numpy(mask), out).numpy(),
                                  np.asarray(jops.upsample_mask(jnp.asarray(mask), out)))


def test_image_pyramid_matches_jax():
    x = np.random.default_rng(3).uniform(-1, 1, size=(2, 65, 83, 3)).astype(np.float32)
    got = tops.build_image_pyramid(torch.from_numpy(x), 5)
    ref = jops.build_image_pyramid(jnp.asarray(x), 5)
    for g, r in zip(got, ref):
        assert_close(g, r, what="pyramid")


def _masks_equal_away_from_edge(inv_t, inv_j, grid):
    g = np.asarray(grid)
    near_edge = np.any(np.abs(np.abs(g) - 1.0) < 1e-6, axis=-1)
    differ = inv_t.numpy() != np.asarray(inv_j)
    assert not np.any(differ & ~near_edge)


@pytest.mark.parametrize("zero_invalid", [False, True])
def test_plain_grid_sample_matches_jax(zero_invalid):
    rng = np.random.default_rng(4)
    image = rng.uniform(-1, 1, size=(2, 12, 16, 5)).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, size=(2, 3, 7, 9, 2)).astype(np.float32)
    grid[0, 0, 0, :3] = [[1.0, -1.0], [-1.0, 1.0], [1.0000001, 0.3]]  # on the border
    before = tcuda_warp.launches
    got, inv = tops.grid_sample(torch.from_numpy(image), torch.from_numpy(grid),
                                zero_invalid=zero_invalid)
    ref, inv_ref = jwarp.grid_sample(jnp.asarray(image), jnp.asarray(grid))
    if zero_invalid:
        ref = jnp.where(inv_ref[..., None], 0.0, ref)
    assert tcuda_warp.launches == before, "a CPU tensor must not reach the kernel"
    assert_close(got, ref, what="grid_sample")
    _masks_equal_away_from_edge(inv, inv_ref, grid)


def test_homography_warps_match_jax():
    rng = np.random.default_rng(5)
    T, _ = jgeo.normalize_baseline(jnp.asarray(poses(rng, 2, scale=0.8)))
    K = Ks(2, 16, 20)
    samples = np.asarray(jgeo.create_idepth_samples(T, jnp.asarray(K), 16, 20, 6))
    H = np.array(jgeo.create_plane_sweep_homographies(T, jnp.asarray(K),
                                                      jnp.asarray(samples)))
    image = rng.uniform(-1, 1, size=(2, 16, 20, 3)).astype(np.float32)

    grid_t = tops.homography_grid(torch.from_numpy(H), 16, 20)
    grid_j = jwarp.homography_grid(jnp.asarray(H), 16, 20)
    assert_close(grid_t, grid_j, what="homography grid")

    got, inv = tops.homography_warp_auto(torch.from_numpy(image), torch.from_numpy(H[:, 2]),
                                         zero_invalid=True)
    ref, inv_ref = jwarp.homography_warp_auto(jnp.asarray(image), jnp.asarray(H[:, 2]),
                                              zero_invalid=True)
    assert_close(got, ref, what="homography_warp_auto")
    _masks_equal_away_from_edge(inv, inv_ref, grid_j[:, 2])

    got, inv = tops.homography_warp(torch.from_numpy(image), torch.from_numpy(H[:, 4]))
    ref, inv_ref = jwarp.homography_warp(jnp.asarray(image), jnp.asarray(H[:, 4]))
    assert_close(got, ref, what="homography_warp")

    got, inv = tops.plane_sweep_warp(torch.from_numpy(image), torch.from_numpy(H))
    ref, inv_ref = jwarp.plane_sweep_warp(jnp.asarray(image), jnp.asarray(H))
    assert got.shape == (2, 6, 16, 20, 3) and inv.shape == (2, 6, 16, 20)
    assert_close(got, ref, what="plane_sweep_warp")
    _masks_equal_away_from_edge(inv, inv_ref, grid_j)


def test_impl_routing_on_cpu():
    """CPU tensors take the plain version; impl='kernel' on a CPU tensor and
    an unknown impl raise instead of falling back."""
    image = torch.zeros(1, 4, 5, 32)
    grid = torch.zeros(1, 4, 5, 2)
    with pytest.raises(ValueError, match="CUDA"):
        tops.grid_sample(image, grid, impl="kernel")
    with pytest.raises(ValueError, match="impl"):
        tops.grid_sample(image, grid, impl="fastest")
    H = torch.eye(3).expand(1, 2, 3, 3)
    with pytest.raises(ValueError, match="CUDA"):
        tchain.incremental_chain(None, image, torch.zeros(1, 2, 4, 5, 3), H, impl="kernel")
    out, inv = tops.grid_sample(image, grid, impl="plain")
    assert out.shape == (1, 4, 5, 32) and not inv.any()


def test_projections_match_jax():
    """normalize_pixel_coords, project_points, project_idepthmap (pixels, idepths and
    the out-of-image mask) and rectified_disparity_to_depth at 64x80, B = 3."""
    rng = np.random.default_rng(6)
    K, T = Ks(3), poses(rng, 3, scale=0.3)
    idepth = rng.uniform(0.1, 0.5, size=(3, 64, 80)).astype(np.float32)
    uv = rng.uniform(-5, 85, size=(3, 64, 80, 2)).astype(np.float32)
    assert_close(tgeo.normalize_pixel_coords(torch.from_numpy(uv), 64, 80),
                 jgeo.normalize_pixel_coords(jnp.asarray(uv), 64, 80), what="normalize")

    points = np.asarray(jgeo.backproject_idepthmap(jnp.asarray(K), jnp.asarray(idepth)))
    Tinv = np.asarray(jgeo.se3_inverse(jnp.asarray(T)))
    assert_close(tgeo.project_points(torch.from_numpy(K), torch.from_numpy(Tinv), (64, 80),
                                     torch.from_numpy(points)),
                 jgeo.project_points(jnp.asarray(K), jnp.asarray(Tinv), (64, 80),
                                     jnp.asarray(points)), what="project_points")

    pix, ids, inv = tgeo.project_idepthmap(torch.from_numpy(K), torch.from_numpy(T),
                                           torch.from_numpy(idepth))
    pix_j, ids_j, inv_j = jgeo.project_idepthmap(jnp.asarray(K), jnp.asarray(T),
                                                 jnp.asarray(idepth))
    assert_close(pix, pix_j, what="project_idepthmap pixels")
    assert_close(ids, ids_j, what="project_idepthmap idepths")
    assert 0 < inv.float().mean() < 1
    _masks_equal_away_from_edge(inv, inv_j, pix_j)

    disp = rng.uniform(0.5, 11, size=(3, 64, 80)).astype(np.float32)
    assert_close(tgeo.rectified_disparity_to_depth(torch.from_numpy(K), torch.from_numpy(T),
                                                   torch.from_numpy(disp)),
                 jgeo.rectified_disparity_to_depth(jnp.asarray(K), jnp.asarray(T),
                                                   jnp.asarray(disp)),
                 what="rectified_disparity_to_depth")

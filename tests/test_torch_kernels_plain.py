"""The plain versions of the port's two kernels against the JAX package.

The incremental chain's plain loop (``ops/cuda/incremental_chain.py``) is
held to the bar the Pallas chain is held to against the scan
(tests/test_fast_paths.py): atol 2e-5 * max|ref|, rtol 2e-4, against
``models/mvsnet.py:_incremental_scan`` with the same weights and inputs.
Weights are seeded at fan-in scale, so the refiner deltas are O(1). The
kernels themselves are compared with these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multi_view_stereonet_tpu import geometry as jgeo
from multi_view_stereonet_tpu.checkpoint import convert_reference_state_dict
from multi_view_stereonet_tpu.models.mvsnet import _incremental_scan
from multi_view_stereonet_tpu.ops import warp as jwarp
from multi_view_stereonet_tpu_torch.checkpoint import random_state_dict
from multi_view_stereonet_tpu_torch.models import FeatureRefiner
from multi_view_stereonet_tpu_torch.ops.cuda import incremental_chain as tchain
from multi_view_stereonet_tpu_torch.ops.cuda import warp as twarp

from tests.test_geometry import random_K, random_pose

CHAIN_ATOL, CHAIN_RTOL = 2e-5, 2e-4
REFINER = "right_feature_extractor.refiner."


def refiner_pair(seed):
    """The same fan-in-scale FeatureRefiner weights for both sides."""
    sd = random_state_dict(seed)
    jparams = convert_reference_state_dict({k: v.numpy() for k, v in sd.items()})
    refiner = FeatureRefiner(32)
    refiner.load_state_dict({k[len(REFINER):]: v for k, v in sd.items()
                             if k.startswith(REFINER)})
    return refiner.eval(), jparams["feature_refiner"]


def chain_inputs(N, D, h, w, seed):
    rng = np.random.default_rng(seed)
    T, _ = jgeo.normalize_baseline(jnp.asarray(
        np.stack([random_pose(rng, scale=0.8) for _ in range(N)])))
    K = jnp.asarray(np.stack([random_K(h, w) for _ in range(N)]))
    samples = jgeo.create_idepth_samples(T, K, h, w, D)
    H_inc = jgeo.incremental_homographies(
        jgeo.create_plane_sweep_homographies(T, K, samples))
    feats0 = rng.normal(size=(N, h, w, 32)).astype(np.float32)
    image_rest = rng.uniform(-1, 1, size=(N, D - 1, h, w, 3)).astype(np.float32)
    return feats0, image_rest, np.array(H_inc)


@pytest.mark.parametrize("N,D,h,w", [(1, 4, 4, 5), (2, 6, 16, 24)])
def test_plain_chain_matches_incremental_scan(N, D, h, w):
    refiner, jparams = refiner_pair(seed=N)
    feats0, image_rest, H_inc = chain_inputs(N, D, h, w, seed=D)

    rest = jax.jit(_incremental_scan)(jparams, feats0, image_rest, H_inc)
    ref = np.concatenate([feats0[:, None], np.asarray(rest)], axis=1)
    before = tchain.launches
    with torch.no_grad():
        got = tchain.incremental_chain(refiner, torch.from_numpy(feats0),
                                       torch.from_numpy(image_rest),
                                       torch.from_numpy(H_inc)).numpy()
    assert tchain.launches == before, "a CPU tensor must not reach the kernel"
    assert got.shape == (N, D, h, w, 32)
    np.testing.assert_array_equal(got[:, 0], feats0)
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got, ref, atol=CHAIN_ATOL * scale, rtol=CHAIN_RTOL)
    # Fan-in weights: every step moves the features by O(1), so a refiner
    # that returned its input unchanged could not pass the check above.
    assert np.abs(ref[:, 1:] - ref[:, :-1]).mean() > 0.1


@pytest.mark.parametrize("shape", [((1, 64, 80, 3), (1, 64, 80, 2)),
                                   ((3, 4, 5, 3), (3, 6, 4, 5, 2))])
def test_plain_grid_sample_call_sites_match_jax(shape):
    """The two call shapes of the serving path: the full-res min-idepth warp
    (zero_invalid) and the level-4 plane sweep volume."""
    image_shape, grid_shape = shape
    rng = np.random.default_rng(7)
    image = rng.uniform(-1, 1, size=image_shape).astype(np.float32)
    grid = rng.uniform(-1.1, 1.1, size=grid_shape).astype(np.float32)
    before = twarp.launches
    got, inv = twarp.grid_sample(torch.from_numpy(image), torch.from_numpy(grid),
                                 zero_invalid=True)
    ref, inv_ref = jwarp.grid_sample(jnp.asarray(image), jnp.asarray(grid))
    ref = jnp.where(inv_ref[..., None], 0.0, ref)
    assert twarp.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(inv.numpy(), np.asarray(inv_ref))

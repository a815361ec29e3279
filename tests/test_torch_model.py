"""The port's network against the JAX package: weights, modules, whole forward.

Both sides get the same seeded fan-in-scale weights (numpy, converted by
``state_dict_from_jax_params`` and its inverse ``convert_reference_state_dict``)
and the same numpy inputs. JAX runs at HIGHEST precision with its plain
(non-space-to-depth) paths, so the comparison is f32 against f32.

Bars:
- weights round trip: bit for bit;
- single modules: atol 2e-5 * max|ref|, rtol 2e-4 (the chain's bar);
- whole forward, every level of ``left_idepthmap_pyr`` and
  ``left_idepthmap_raw_pyr``: max abs error <= 0.2% of that level's output
  range (the bar docs/PARITY.md:152-154 holds JAX to against the
  reference); masks equal on >= 99.9% of voxels (|g| > 1 flips at the ulp
  level are expected).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multi_view_stereonet_tpu import ops as jops
from multi_view_stereonet_tpu.checkpoint import convert_reference_state_dict
from multi_view_stereonet_tpu.geometry import build_K_pyramid as jax_K_pyramid
from multi_view_stereonet_tpu.models import (
    MultiViewStereoNetConfig as JaxConfig, init_mvsnet, mvsnet_forward as jax_forward)
from multi_view_stereonet_tpu.models.cost_volume import (
    cost_volume_filter as jax_cost_filter, extract_idepthmap as jax_extract)
from multi_view_stereonet_tpu.models.feature_network import feature_network as jax_features
from multi_view_stereonet_tpu.models.refiners import idepthmap_refiner as jax_idepth_refiner
from multi_view_stereonet_tpu_torch import ops as tops
from multi_view_stereonet_tpu_torch.checkpoint import (
    init_params_numpy, random_state_dict, state_dict_from_jax_params)
from multi_view_stereonet_tpu_torch.geometry import build_K_pyramid
from multi_view_stereonet_tpu_torch.models import (
    MultiViewStereoNet, MultiViewStereoNetConfig, mvsnet_forward)

from tests.test_model_parity import make_inputs

JAX_PARITY = dict(matmul_precision="highest", use_s2d_refiners=False,
                  use_s2d_chained_frontend=False, use_s2d_cost_filter=False)
MODULE_ATOL, MODULE_RTOL = 2e-5, 2e-4
FORWARD_BAR = 2e-3
MASK_AGREEMENT = 0.999
KEYS = ("left_idepthmap_pyr", "left_idepthmap_raw_pyr", "left_idepthmap_mask_pyr")


def weights(seed):
    """(port model, JAX params) holding the same seeded fan-in-scale weights."""
    sd = random_state_dict(seed)
    model = MultiViewStereoNet()
    model.load_state_dict(sd)
    return model.eval(), convert_reference_state_dict({k: v.numpy() for k, v in sd.items()})


def jax_model_forward(params, left, rights, K, T, config):
    B, V, H, W = rights.shape[:4]

    def run(params, left, rights, K, T):
        left_pyr = jops.build_image_pyramid(left, 5)
        flat = jops.build_image_pyramid(rights.reshape(B * V, H, W, 3), 5)
        right_pyrs = [r.reshape(B, V, *r.shape[1:]) for r in flat]
        K_pyr = jax_K_pyramid(K, [(p.shape[1], p.shape[2]) for p in left_pyr])
        return jax_forward(params, left_pyr, K_pyr, T, right_pyrs, config)

    out = jax.jit(run)(params, left, rights, K, T)
    return {k: [np.asarray(x) for x in v] for k, v in out.items()}


def port_model_forward(model, left, rights, K, T, config, impl="auto"):
    B, V, H, W = rights.shape[:4]
    with torch.no_grad():
        left_pyr = tops.build_image_pyramid(torch.from_numpy(left), 5)
        flat = tops.build_image_pyramid(torch.from_numpy(rights).reshape(B * V, H, W, 3), 5)
        right_pyrs = [r.reshape(B, V, *r.shape[1:]) for r in flat]
        K_pyr = build_K_pyramid(torch.from_numpy(K),
                                [(p.shape[1], p.shape[2]) for p in left_pyr])
        out = mvsnet_forward(model, left_pyr, K_pyr, torch.from_numpy(T), right_pyrs,
                             config, impl)
    return {k: [x.numpy() for x in v] for k, v in out.items()}


def assert_forward_close(got, ref, bar=FORWARD_BAR):
    for key in KEYS[:2]:
        for lvl in range(5):
            g, r = got[key][lvl], ref[key][lvl]
            assert g.shape == r.shape, (key, lvl, g.shape, r.shape)
            span = float(r.max() - r.min())
            assert np.isfinite(g).all() and span > 0, (key, lvl)
            err = float(np.abs(g - r).max())
            assert err <= bar * span, f"{key}[{lvl}]: {err:.3e} > {bar} * {span:.3e}"
    for lvl in range(5):
        g, r = got[KEYS[2]][lvl], ref[KEYS[2]][lvl]
        assert g.shape == r.shape and g.dtype == np.bool_
        assert np.mean(g == r) >= MASK_AGREEMENT, f"mask level {lvl}"


def nhwc_inputs(B, V, seed, H=64, W=80):
    left, rights, K, T = make_inputs(B=B, V=V, H=H, W=W, seed=seed)
    return (np.ascontiguousarray(np.moveaxis(left, 1, -1)),
            np.ascontiguousarray(np.moveaxis(rights, 2, -1)), K, T)


def test_weights_round_trip_bit_exact():
    """init_mvsnet -> numpy -> state_dict_from_jax_params ->
    convert_reference_state_dict reproduces the pytree bit for bit, and the
    state dict loads strictly into the port's module tree."""
    params = jax.tree.map(np.asarray, init_mvsnet(jax.random.PRNGKey(0)))
    sd = state_dict_from_jax_params(params)
    back = convert_reference_state_dict({k: v.numpy() for k, v in sd.items()})
    leaves, tree = jax.tree.flatten(params)
    back_leaves, back_tree = jax.tree.flatten(back)
    assert tree == back_tree
    for a, b in zip(leaves, back_leaves):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a.view(np.uint32), np.asarray(b).view(np.uint32))
    model = MultiViewStereoNet()
    model.load_state_dict(sd, strict=True)
    assert set(model.state_dict()) == set(sd)


def test_fan_in_init_is_seeded_and_scaled():
    a, b = init_params_numpy(5), init_params_numpy(5)
    jax.tree.map(np.testing.assert_array_equal, a, b)
    w = a["refiner0"]["res2"]["conv"]["w"]  # (3, 3, 32, 32): fan-in 288
    assert abs(float(w.std()) - 288 ** -0.5) < 0.01
    assert abs(float(a["refiner0"]["gn0"]["scale"].mean()) - 1.0) < 0.1


def _module_close(got, ref):
    ref = np.asarray(ref)
    got = got.detach().numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=MODULE_ATOL * float(np.abs(ref).max()),
                               rtol=MODULE_RTOL)


@pytest.mark.parametrize("module", ["feature_network", "idepthmap_refiner",
                                    "cost_volume_filter"])
def test_modules_match_jax(module):
    model, params = weights(seed=11)
    rng = np.random.default_rng(12)
    with jax.default_matmul_precision("highest"), torch.no_grad():
        if module == "feature_network":
            x = rng.uniform(-1, 1, size=(2, 48, 64, 3)).astype(np.float32)
            got = model.left_feature_extractor(torch.from_numpy(x).permute(0, 3, 1, 2))
            ref = jax.jit(jax_features)(params["feature_network"], x)
            for g, r in zip(got, ref):
                _module_close(g.permute(0, 2, 3, 1), r)
        elif module == "idepthmap_refiner":
            guidance = rng.uniform(-1, 1, size=(2, 12, 16, 35)).astype(np.float32)
            idepth = rng.uniform(0, 40, size=(2, 12, 16)).astype(np.float32)
            got = model.refiner2(torch.from_numpy(guidance).permute(0, 3, 1, 2),
                                 torch.from_numpy(idepth))
            _module_close(got, jax.jit(jax_idepth_refiner)(params["refiner2"], guidance,
                                                           idepth))
        else:
            volume = np.abs(rng.normal(size=(2, 6, 4, 5, 32))).astype(np.float32)
            samples = np.sort(rng.uniform(0, 1, size=(2, 6)), axis=1).astype(np.float32)
            got = model.volume_filter4(torch.from_numpy(volume).permute(0, 4, 1, 2, 3))
            ref = jax.jit(jax_cost_filter)(params["volume_filter4"], volume)
            _module_close(got, ref)
            from multi_view_stereonet_tpu_torch.models import extract_idepthmap
            _module_close(extract_idepthmap(got, torch.from_numpy(samples)),
                          jax_extract(ref, jnp.asarray(samples)))


# Seeds whose random poses leave valid pixels at level 4 (a pose with none
# gives NaN hypotheses on both sides, as the reference does). The B=1 cases keep
# their ids; training runs B=8, hence the B=2 cases, and D 9 and 16.
@pytest.mark.parametrize("seed,B,V,D,cvf,refiners", [
    pytest.param(0, 1, 1, 4, True, (True,) * 5, id="0-1-4-True-refiners0"),
    pytest.param(1, 1, 2, 6, True, (True,) * 5, id="1-2-6-True-refiners1"),
    # refiner4 off: baseline^2 quirk
    pytest.param(2, 1, 1, 4, True, (True, True, True, True, False), id="2-1-4-True-refiners2"),
    pytest.param(3, 1, 1, 6, False, (True,) * 5, id="3-1-6-False-refiners3"),  # filter off
    pytest.param(20, 2, 2, 4, True, (True,) * 5, id="B2-20-2-4-True"),
    pytest.param(24, 1, 2, 9, False, (True,) * 5, id="B1-24-2-9-False"),
    pytest.param(21, 2, 2, 16, True, (False, True, True, True, False), id="B2-21-2-16-ends-off"),
    pytest.param(20, 2, 1, 9, True, (True,) * 5, id="B2-20-1-9-True"),
])
def test_forward_matches_jax(seed, B, V, D, cvf, refiners):
    model, params = weights(seed)
    left, rights, K, T = nhwc_inputs(B, V, seed)
    ref = jax_model_forward(params, left, rights, K, T, JaxConfig(
        num_idepth_samples=D, do_cost_volume_filter=cvf, do_refiners=refiners,
        **JAX_PARITY))
    got = port_model_forward(model, left, rights, K, T, MultiViewStereoNetConfig(
        num_idepth_samples=D, do_cost_volume_filter=cvf, do_refiners=refiners))
    assert got["left_idepthmap_mask_pyr"][4].shape == (B, D, 4, 5)
    assert_forward_close(got, ref)
    if not refiners[4]:
        np.testing.assert_array_equal(got[KEYS[0]][4], got[KEYS[1]][4])


def test_forward_rejects_a_pyramid_of_another_depth():
    model, _ = weights(0)
    left, rights, K, T = nhwc_inputs(1, 1, 0)
    with pytest.raises(ValueError, match="pyramid levels"):
        port_model_forward(model, left, rights, K, T,
                           MultiViewStereoNetConfig(num_idepth_samples=4, num_levels=4))

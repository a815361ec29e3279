"""Randomized forward-config sweep of the port against the JAX forward.

The port's counterpart of tests/test_model_fuzz.py, drawn the same way: the
hypothesis count D in {4, 6, 9, 16}, any refiner mask (all off and refiner 4 alone
included), the cost filter on or off, B and V in {1, 2}; and the compute dtype,
float32 or bfloat16. Both sides get the same seeded fan-in-scale weights and numpy
inputs at 64x80 (tests/test_torch_model.py's helpers, JAX at ``JAX_PARITY``); every
draw is reproducible and none is re-drawn. Bars: test_torch_model.py's at f32
(0.2% of each level's range), test_torch_bf16.py's at bf16. A draw that leaves no
valid pixel at level 4 gives NaN hypotheses on both sides (as the reference does):
there the NaNs must sit at the same places, and the finite values meet the bar.
"""

import numpy as np
import pytest

from multi_view_stereonet_tpu.models import MultiViewStereoNetConfig as JaxConfig
from multi_view_stereonet_tpu_torch.models import MultiViewStereoNetConfig

from tests.test_torch_bf16 import FORWARD_MAX, FORWARD_MEAN
from tests.test_torch_model import (
    FORWARD_BAR, JAX_PARITY, KEYS, MASK_AGREEMENT, jax_model_forward, nhwc_inputs,
    port_model_forward, weights)

TRIALS = 8


def draw_config(rng):
    D = int(rng.choice([4, 6, 9, 16]))
    cvf = bool(rng.integers(0, 2))
    refiners = tuple(bool(b) for b in rng.integers(0, 2, size=5))
    B = int(rng.choice([1, 2]))
    V = int(rng.choice([1, 2]))
    dtype = str(rng.choice(["float32", "bfloat16"]))
    return D, cvf, refiners, B, V, dtype


def assert_level_close(g, r, max_bar, mean_bar, what):
    assert g.shape == r.shape and g.dtype == np.float32, what
    nan = np.isnan(r)
    np.testing.assert_array_equal(np.isnan(g), nan, err_msg=f"{what}: NaN places")
    if nan.all():
        return
    g, r = g[~nan], r[~nan]
    assert np.isfinite(g).all() and np.isfinite(r).all(), what
    span = max(float(r.max() - r.min()), 1e-30)
    err = np.abs(g - r)
    assert err.max() <= max_bar * span, f"{what}: max {err.max():.3e} of range {span:.3e}"
    if mean_bar is not None:
        assert err.mean() <= mean_bar * span, f"{what}: mean {err.mean():.3e}"


@pytest.mark.parametrize("trial", range(TRIALS))
def test_forward_matches_jax_at_a_random_config(trial):
    rng = np.random.default_rng(100 + trial)
    D, cvf, refiners, B, V, dtype = draw_config(rng)
    config = f"D={D} cvf={cvf} refiners={refiners} B={B} V={V} {dtype}"
    model, params = weights(seed=trial)
    left, rights, K, T = nhwc_inputs(B, V, seed=200 + trial)
    knobs = dict(num_idepth_samples=D, do_cost_volume_filter=cvf, do_refiners=refiners,
                 compute_dtype=dtype)
    ref = jax_model_forward(params, left, rights, K, T, JaxConfig(**knobs, **JAX_PARITY))
    got = port_model_forward(model, left, rights, K, T, MultiViewStereoNetConfig(**knobs))
    bars = (FORWARD_BAR, None) if dtype == "float32" else (FORWARD_MAX, FORWARD_MEAN)
    for key in KEYS[:2]:
        for lvl in range(5):
            assert_level_close(got[key][lvl], ref[key][lvl], *bars,
                               f"{config}: {key}[{lvl}]")
    for lvl in range(5):
        g, r = got[KEYS[2]][lvl], ref[KEYS[2]][lvl]
        assert g.shape == r.shape and g.dtype == np.bool_
        assert np.mean(g == r) >= MASK_AGREEMENT, f"{config}: mask level {lvl}"

"""The plain versions of the port's idepthmap-refiner (K3) and GroupNorm-tail (K4)
kernels against the JAX package, on the CPU.

On the CPU the wrappers in ``ops/cuda/refiner.py`` and ``ops/cuda/gn_apply.py``
take their plain versions; the kernels themselves are held against those on the
card (tests/test_torch_cuda.py, chip_smoke.py). The JAX side runs as the JAX
package's own tests run it: the Pallas GN-apply kernel in interpret mode, the
refiner through its XLA paths (plain and s2d), and the Pallas refiner under
``force_tpu_interpret_mode`` (slow).

Bars:
- K4: max abs error <= 1e-5 * max(1, max|ref|);
- K3: atol 2e-5 * max|ref|, rtol 2e-4 (the chain's bar);
- whole forward: every level within 0.2% of its output range
  (tests/test_torch_model.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multi_view_stereonet_tpu.models import MultiViewStereoNetConfig as JaxConfig
from multi_view_stereonet_tpu.models.layers import resnet_block as jax_resnet_block
from multi_view_stereonet_tpu.models.refiners import idepthmap_refiner as jax_idepth_refiner
from multi_view_stereonet_tpu.models.s2d import (
    depth_to_space, idepthmap_refiner_s2d, space_to_depth)
from multi_view_stereonet_tpu.ops.pallas.gn_apply import gn_apply_residual_fused
from multi_view_stereonet_tpu_torch.models import MultiViewStereoNetConfig, ResnetBlock
from multi_view_stereonet_tpu_torch.ops.cuda import gn_apply
from multi_view_stereonet_tpu_torch.ops.cuda import refiner as refiner_op
from multi_view_stereonet_tpu_torch.train.pipeline import pyramid_sizes

from tests.test_torch_model import (
    JAX_PARITY, assert_forward_close, jax_model_forward, nhwc_inputs, port_model_forward,
    weights)

GN_BAR = 1e-5
REFINER_ATOL, REFINER_RTOL = 2e-5, 2e-4


def gn_inputs(shape, seed):
    """x, res (NCHW), gamma, beta as numpy f32; x off-centre, as a conv output is."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * 2 + 0.5).astype(np.float32)
    res = rng.normal(size=shape).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, size=shape[1]).astype(np.float32)
    beta = (rng.normal(size=shape[1]) * 0.1).astype(np.float32)
    return x, res, gamma, beta


def nhwc(a):
    return np.ascontiguousarray(np.moveaxis(a, 1, -1))


def assert_gn_close(got, ref):
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    err = float(np.abs(got - ref).max())
    assert err <= GN_BAR * max(1.0, float(np.abs(ref).max())), err


def test_gn_apply_plain_matches_pallas_interpret():
    """K4 plain vs ``gn_apply_residual_fused`` (its statistics from gn_s2d_stats),
    run in interpret mode on the s2d layout the TPU kernel takes."""
    x, res, gamma, beta = gn_inputs((2, 32, 12, 32), seed=0)
    before = gn_apply.launches
    got = gn_apply.gn_apply_residual(torch.from_numpy(x), torch.from_numpy(res),
                                     torch.from_numpy(gamma), torch.from_numpy(beta), 4)
    assert gn_apply.launches == before, "a CPU tensor must not reach the kernel"
    out = gn_apply_residual_fused({"scale": jnp.asarray(gamma), "bias": jnp.asarray(beta)},
                                  space_to_depth(jnp.asarray(nhwc(x))),
                                  space_to_depth(jnp.asarray(nhwc(res))), 4, True)
    assert_gn_close(nhwc(got.numpy()), depth_to_space(out))


@pytest.mark.parametrize("dilation", [1, 2])
def test_resnet_block_matches_jax(dilation):
    """The port's ResnetBlock (conv, then the K4 wrapper) vs ``layers.resnet_block``."""
    x, _, gamma, beta = gn_inputs((2, 32, 12, 16), seed=dilation)
    rng = np.random.default_rng(10 + dilation)
    w = (rng.normal(size=(3, 3, 32, 32)) / np.sqrt(288)).astype(np.float32)
    b = (rng.normal(size=32) * 0.1).astype(np.float32)
    block = ResnetBlock(32, dilation=dilation)
    with torch.no_grad():
        block.conv1.weight.copy_(torch.from_numpy(w).permute(3, 2, 0, 1))
        block.conv1.bias.copy_(torch.from_numpy(b))
        block.bn1.weight.copy_(torch.from_numpy(gamma))
        block.bn1.bias.copy_(torch.from_numpy(beta))
        got = block(torch.from_numpy(x)).numpy()
    params = {"conv": {"w": jnp.asarray(w), "b": jnp.asarray(b)},
              "gn": {"scale": jnp.asarray(gamma), "bias": jnp.asarray(beta)}}
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(jax_resnet_block, static_argnums=2)(params, nhwc(x), dilation)
    assert_gn_close(nhwc(got), ref)


def refiner_case(cg, h, w, seed=3):
    """(port refiner, JAX params, guidance NHWC, idepth): refiner4's weights for the
    feature-guided shape (cg = 35), refiner0's for the image-only one (cg = 3)."""
    model, params = weights(seed)
    name = "refiner4" if cg == 35 else "refiner0"
    rng = np.random.default_rng(cg)
    guidance = rng.uniform(-1, 1, size=(2, h, w, cg)).astype(np.float32)
    idepth = rng.uniform(0, 20, size=(2, h, w)).astype(np.float32)
    return getattr(model, name), params[name], guidance, idepth


def port_refiner(refiner, guidance, idepth):
    before = refiner_op.launches
    with torch.no_grad():
        out = refiner_op.idepthmap_refiner(
            refiner, torch.from_numpy(np.ascontiguousarray(guidance.transpose(0, 3, 1, 2))),
            torch.from_numpy(idepth))
    assert refiner_op.launches == before, "a CPU tensor must not reach the kernel"
    return out.numpy()


def assert_refiner_close(got, ref):
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=REFINER_ATOL * float(np.abs(ref).max()),
                               rtol=REFINER_RTOL)


@pytest.mark.parametrize("reference", ["s2d", "plain"])
@pytest.mark.parametrize("cg,h,w", [(35, 30, 40), (3, 16, 24)])
def test_refiner_plain_matches_jax(cg, h, w, reference):
    """K3 plain (the IDepthmapRefiner module, impl='plain') vs the XLA refiners:
    ``s2d.idepthmap_refiner_s2d`` and ``refiners.idepthmap_refiner``."""
    refiner, params, guidance, idepth = refiner_case(cg, h, w)
    got = port_refiner(refiner, guidance, idepth)
    fn = idepthmap_refiner_s2d if reference == "s2d" else jax_idepth_refiner
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(fn)(params, guidance, idepth)
    assert_refiner_close(got, ref)
    # Fan-in weights: the refiner moves the map, so returning ReLU(idepth) fails.
    assert np.abs(np.asarray(ref) - np.maximum(idepth, 0)).mean() > 0.01


@pytest.mark.slow
@pytest.mark.parametrize("cg,h,w", [(35, 30, 40), (3, 16, 24)])
def test_refiner_plain_matches_pallas_interpret(cg, h, w):
    """K3 plain vs the Pallas refiner itself, through the Pallas interpreter."""
    from jax.experimental.pallas import tpu as pltpu

    from multi_view_stereonet_tpu.ops.pallas.refiner_kernel import idepthmap_refiner_fused

    refiner, params, guidance, idepth = refiner_case(cg, h, w)
    got = port_refiner(refiner, guidance, idepth)
    try:
        with pltpu.force_tpu_interpret_mode():
            ref = idepthmap_refiner_fused(params, jnp.asarray(guidance), jnp.asarray(idepth))
    except Exception as e:  # interpreter support varies across jax versions
        pytest.skip(f"pallas interpret mode unavailable: {e}")
    assert_refiner_close(got, ref)


# Seeds whose random poses leave valid pixels at level 4 (tests/test_torch_model.py).
@pytest.mark.parametrize("seed,V,D", [(0, 1, 4), (1, 2, 6)])
def test_forward_matches_jax_with_fused_small_refiners(seed, V, D):
    """The whole forward with the port's refiner routing against the JAX forward
    configured to send the small levels through its fused refiner."""
    model, params = weights(seed)
    left, rights, K, T = nhwc_inputs(1, V, seed)
    ref = jax_model_forward(params, left, rights, K, T, JaxConfig(
        num_idepth_samples=D, use_fused_small_refiners=True, **JAX_PARITY))
    before = (refiner_op.launches, gn_apply.launches)
    got = port_model_forward(model, left, rights, K, T,
                             MultiViewStereoNetConfig(num_idepth_samples=D))
    assert (refiner_op.launches, gn_apply.launches) == before
    assert_forward_close(got, ref)


@pytest.mark.parametrize("n", [1, 2, 8, 9])
def test_fused_refiner_gate_selects_levels_4_and_3(n):
    """At 480x640 the gate takes exactly levels 3 (60x80) and 4 (30x40), for up
    to 8 samples."""
    chosen = [lvl for lvl, (h, w) in enumerate(pyramid_sizes(480, 640, 5))
              if refiner_op.fused_refiner_supported(h, w, n)]
    assert chosen == ([3, 4] if n <= 8 else [])


def test_kernel_impl_refuses_cpu_tensors():
    refiner, _, guidance, idepth = refiner_case(3, 8, 8)
    guidance = torch.from_numpy(guidance.transpose(0, 3, 1, 2).copy())
    with pytest.raises(ValueError, match="CUDA"):
        refiner_op.idepthmap_refiner(refiner, guidance, torch.from_numpy(idepth),
                                     impl="kernel")
    x = torch.zeros(1, 32, 4, 4)
    with pytest.raises(ValueError, match="CUDA"):
        gn_apply.gn_apply_residual(x, x, torch.ones(32), torch.zeros(32), 4, impl="kernel")

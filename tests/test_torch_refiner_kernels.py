"""The plain versions of the port's idepthmap-refiner (K3) and GroupNorm (K4)
kernels against the JAX package, on the CPU.

On the CPU the wrappers in ``ops/cuda/refiner.py`` and ``ops/cuda/gn_apply.py``
take their plain versions; the kernels themselves are held against those on the
card (tests/test_torch_cuda.py, chip_smoke.py). The JAX side runs as the JAX
package's own tests run it: the Pallas GN-apply kernel in interpret mode, the
refiner through its XLA paths (plain and s2d), and the Pallas refiner under
``force_tpu_interpret_mode`` (slow). What of K3's kernel path runs on the CPU is
checked here too: the packed-weight image and its cache, and the kernel's 3xTF32
operand split, emulated in torch through the whole refiner.

Bars:
- K4 and the modules it serves (bn0's refiner, the cost filter): max abs error
  <= 1e-5 * max(1, max|ref|);
- K3: atol 2e-5 * max|ref|, rtol 2e-4 (the chain's bar);
- whole forward: every level within 0.2% of its output range
  (tests/test_torch_model.py).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from multi_view_stereonet_tpu.models import MultiViewStereoNetConfig as JaxConfig
from multi_view_stereonet_tpu.models.cost_volume import cost_volume_filter as jax_cost_filter
from multi_view_stereonet_tpu.models.layers import group_norm as jax_group_norm
from multi_view_stereonet_tpu.models.layers import leaky_relu as jax_leaky_relu
from multi_view_stereonet_tpu.models.layers import resnet_block as jax_resnet_block
from multi_view_stereonet_tpu.models.refiners import idepthmap_refiner as jax_idepth_refiner
from multi_view_stereonet_tpu.models.s2d import (
    depth_to_space, idepthmap_refiner_s2d, space_to_depth)
from multi_view_stereonet_tpu.ops.pallas.gn_apply import gn_apply_residual_fused
from multi_view_stereonet_tpu_torch.models import MultiViewStereoNetConfig, ResnetBlock
from multi_view_stereonet_tpu_torch.models.refiners import DILATIONS
from multi_view_stereonet_tpu_torch.ops.cuda.incremental_chain import _taps
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
    """Channels last: NCHW -> NHWC, NCDHW -> NDHWC."""
    return np.ascontiguousarray(np.moveaxis(a, 1, -1))


def nchw(a):
    """Channels first: NHWC -> NCHW."""
    return np.ascontiguousarray(np.moveaxis(a, -1, 1))


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


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("shape", [(2, 32, 12, 16), (2, 32, 4, 16, 20)])
def test_group_norm_act_plain_matches_jax(shape, residual):
    """K4's generalised op, plain (CPU tensors), NCHW and NCDHW, with and without the
    residual, vs ``leaky_relu(group_norm(...))`` (+ res) of the JAX layers."""
    x, res, gamma, beta = gn_inputs(shape, seed=len(shape) + residual)
    before = gn_apply.launches
    got = gn_apply.group_norm_act(torch.from_numpy(x), torch.from_numpy(gamma),
                                  torch.from_numpy(beta), 4,
                                  torch.from_numpy(res) if residual else None)
    assert gn_apply.launches == before, "a CPU tensor must not reach the kernel"
    params = {"scale": jnp.asarray(gamma), "bias": jnp.asarray(beta)}
    ref = jax_leaky_relu(jax_group_norm(params, jnp.asarray(nhwc(x)), groups=4))
    if residual:
        ref = ref + nhwc(res)
    assert_gn_close(nhwc(got.numpy()), ref)


H100_SMS = 132  # multiprocessors of an NVIDIA H100 80GB HBM3


@pytest.mark.parametrize("shape,chunks", [
    ((2, 32, 30, 40), 3),         # extractor, level 4 (B + B*V = 2): 8 rows of 9600
    ((3, 32, 5, 7), 1),           # a row under MIN_CHUNK: one chunk
    ((1, 32, 12, 30, 40), 29),    # cost filter, N = B*V = 1: 4 rows
    ((5, 32, 12, 30, 40), 27),    # cost filter, N = 5: 20 rows
    ((1, 32, 120, 160), 38),      # refiner 2
    ((1, 32, 240, 320), 132),     # refiner 1
    ((8, 32, 240, 320), 17),      # 32 rows: the block target split over them
    ((1, 32, 480, 640), 132),     # refiner 0: 9.4 MiB a row
])
def test_group_norm_act_chunking(shape, chunks):
    """How the kernel cuts each (sample, group) row at the serving shapes on an H100:
    chunks of a multiple of 4 floats covering the row with none empty, about
    BLOCKS_PER_SM blocks per SM in all, none cut finer than MIN_CHUNK needs."""
    rows, L = shape[0] * 4, int(np.prod(shape[1:])) // 4
    chunk, n = gn_apply.chunking(rows, L, gn_apply.BLOCKS_PER_SM * H100_SMS)
    assert n == chunks
    assert chunk % 4 == 0
    assert (n - 1) * chunk < L <= n * chunk
    assert n <= -(-L // gn_apply.MIN_CHUNK)
    assert n <= -(-gn_apply.BLOCKS_PER_SM * H100_SMS // rows)


@pytest.mark.parametrize("module", ["refiner0", "volume_filter4"])
def test_group_norm_act_modules_match_jax(module):
    """The modules whose bn0 / GroupNorms now go through K4's op, plain on the CPU:
    refiner0 at a level-0-like (image-only guidance) size and the cost filter at
    (2, 32, 4, 16, 20), each against its JAX function with the same weights."""
    model, params = weights(seed=21)
    rng = np.random.default_rng(22)
    with jax.default_matmul_precision("highest"), torch.no_grad():
        if module == "refiner0":
            guidance = rng.uniform(-1, 1, size=(2, 48, 64, 3)).astype(np.float32)
            idepth = rng.uniform(0, 20, size=(2, 48, 64)).astype(np.float32)
            got = model.refiner0(torch.from_numpy(nchw(guidance)), torch.from_numpy(idepth))
            ref = jax.jit(jax_idepth_refiner)(params["refiner0"], guidance, idepth)
        else:
            volume = np.abs(rng.normal(size=(2, 4, 16, 20, 32))).astype(np.float32)
            got = model.volume_filter4(torch.from_numpy(nchw(volume)))
            ref = jax.jit(jax_cost_filter)(params["volume_filter4"], volume)
    assert_gn_close(got.numpy(), ref)


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


def swizzled_back(w):
    """Undo the kernel's column swizzle (its own inverse) of a (..., rows, cols) image."""
    r = torch.arange(w.shape[-2])[:, None]
    s = (r & 3) << 2 if w.shape[-1] == 32 else ((r >> 1) & 1) << 2
    return w.gather(-1, (torch.arange(w.shape[-1])[None, :] ^ s).expand(w.shape))


def test_packed_weights_layout():
    """The packed image holds every weight as hi + lo (hi on the TF32 grid, lo exact) in
    [tap][ci][oc] order under the kernel's column swizzle, conv0's rows padded to a
    multiple of 4, the final conv in column 0 of 8, then the bias and GroupNorm vector."""
    refiner, _, _, _ = refiner_case(35, 30, 40)
    pack, dilations = refiner_op.packed_weights(refiner)
    assert tuple(dilations) == DILATIONS
    n0, nr, nf = 2 * 9 * 36 * 32, 2 * 6 * 9 * 32 * 32, 2 * 9 * 32 * 8
    assert pack.shape == (n0 + nr + nf + 7 * 96 + 1,)
    w0 = pack[:n0].view(9, 36, 32, 2)
    wr = pack[n0:n0 + nr].view(6, 9, 32, 32, 2)
    wf = pack[n0 + nr:n0 + nr + nf].view(9, 32, 8, 2)
    for image in (w0, wr, wf):
        assert not (image[..., 0].view(torch.int32) & 0x1FFF).any()  # hi is TF32
    assert torch.equal(swizzled_back(w0[..., 0] + w0[..., 1]), _taps(refiner.conv0.weight))
    blocks = [getattr(refiner, f"res{i}") for i in range(6)]
    assert torch.equal(swizzled_back(wr[..., 0] + wr[..., 1]),
                       torch.stack([_taps(b.conv1.weight) for b in blocks]))
    final = swizzled_back(wf[..., 0] + wf[..., 1])
    assert torch.equal(final[..., :1], _taps(refiner.conv_final.weight))
    assert not final[..., 1:].any()
    vec = pack[n0 + nr + nf:]
    assert torch.equal(vec[:96], torch.cat([refiner.conv0.bias, refiner.bn0.weight,
                                            refiner.bn0.bias]).detach())
    assert vec[-1] == refiner.conv_final.bias[0]
    # The image-only refiner: conv0's 4 input channels need no padding rows.
    refiner0, _, _, _ = refiner_case(3, 16, 24)
    pack0, _ = refiner_op.packed_weights(refiner0)
    assert torch.equal(swizzled_back(pack0[:2 * 9 * 4 * 32].view(9, 4, 32, 2).sum(-1)),
                       _taps(refiner0.conv0.weight))


def test_packed_weights_cached_until_a_parameter_changes():
    """One packing while the parameters are unchanged; a new one after an in-place
    update and after load_state_dict, equal to a fresh packing of the new weights."""
    refiner, _, _, _ = refiner_case(35, 30, 40)
    pack = refiner_op.packed_weights(refiner)[0]
    assert refiner_op.packed_weights(refiner)[0] is pack
    with torch.no_grad():
        refiner.res2.conv1.weight.mul_(0.5)
    updated = refiner_op.packed_weights(refiner)[0]
    assert updated is not pack and not torch.equal(updated, pack)
    assert refiner_op.packed_weights(refiner)[0] is updated
    other, _, _, _ = refiner_case(35, 30, 40, seed=4)
    refiner.load_state_dict(other.state_dict())
    reloaded = refiner_op.packed_weights(refiner)[0]
    assert reloaded is not updated
    assert torch.equal(reloaded, refiner_op.packed_weights(other)[0])
    assert refiner_op.packed_weights(refiner)[0] is reloaded


def tf32_truncate(x):
    """What the tensor core reads of an f32 operand: its top 19 bits."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def refiner_tf32(refiner, guidance, idepth, terms):
    """The refiner with every conv done as the kernel does it on the tensor cores: each
    operand split on its bits (``tf32_split``), lo read as TF32, and the products
    hi*hi + hi*lo + lo*hi (terms = 3, 3xTF32) or hi*hi alone (terms = 1, TF32)."""
    def conv(x, c):
        xh, xl = refiner_op.tf32_split(x)
        wh, wl = refiner_op.tf32_split(c.weight)

        def f(a, b):
            return F.conv2d(a, b, None, padding=c.padding, dilation=c.dilation)
        out = f(xh, wh)
        if terms == 3:
            out = f(tf32_truncate(xl), wh) + f(xh, tf32_truncate(wl)) + out
        return out + c.bias[:, None, None]

    def gn(bn, x):
        return F.leaky_relu(F.group_norm(x, 4, bn.weight, bn.bias, 1e-5), 0.2)
    x = gn(refiner.bn0, conv(torch.cat([guidance, idepth[:, None]], 1), refiner.conv0))
    for i in range(6):
        block = getattr(refiner, f"res{i}")
        x = x + gn(block.bn1, conv(x, block.conv1))
    return torch.relu(idepth + conv(x, refiner.conv_final)[:, 0])


def test_refiner_3xtf32_split_holds_the_bar():
    """The kernel's operand split through the whole refiner at (1,35,30,40), emulated
    in torch, against the JAX ``idepthmap_refiner``: 3xTF32 holds the chain bar, and
    TF32 alone (one product) does not, so the bar tells the two apart."""
    refiner, params, guidance, idepth = refiner_case(35, 30, 40)
    guidance, idepth = guidance[:1], idepth[:1]
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax.jit(jax_idepth_refiner)(params, guidance, idepth))
    g = torch.from_numpy(np.ascontiguousarray(guidance.transpose(0, 3, 1, 2)))
    with torch.no_grad():
        got = refiner_tf32(refiner, g, torch.from_numpy(idepth), terms=3).numpy()
        tf32 = refiner_tf32(refiner, g, torch.from_numpy(idepth), terms=1).numpy()
    assert_refiner_close(got, ref)
    with pytest.raises(AssertionError):
        assert_refiner_close(tf32, ref)


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
    volume = torch.zeros(1, 32, 2, 4, 4)
    with pytest.raises(ValueError, match="CUDA"):
        gn_apply.group_norm_act(volume, torch.ones(32), torch.zeros(32), 4, impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        gn_apply.group_norm_act_kernel(volume, torch.ones(32), torch.zeros(32), 4)

"""The port's training step against the JAX package's, on the CPU.

- Gradients: the port's ``make_loss_fn`` and ``loss.backward()`` against
  ``jax.value_and_grad`` of the JAX ``make_loss_fn`` (HIGHEST precision, plain
  paths), on the same batch dict and the same seeded fan-in-scale weights, the
  JAX gradient tree mapped to the port's names by ``state_dict_from_jax_params``.
  Bar (docs/PARITY.md:218-232): per parameter max|diff| <= 2.5e-3 * max|ref|,
  cosine > 0.999998, a leaf whose reference is below 1e-4 of the largest one
  (``volume_filter4.conv4.bias``, whose true gradient is 0: the soft-argmin over D
  ignores a constant shift) held to that floor instead; the loss within 1e-5
  relative. Cases at 64x80: B=2 V=2 D=4 and B=2 V=1 D=9, seed 20 (level-4 grids
  with valid pixels). The u8 transports give the f32 feed's loss bit for bit.
- The slice as a whole, the two-view recipe with every loss branch
  (``multi_view=False``, ``estimate_right_idepthmap``, supervision 1.0, left-right and
  reconstruction 0.5) on a rendered tilted-plane pair, B=1 D=4, at the same bar; its
  u8 transports bit for bit.
- Each kernel's ``torch.autograd.Function`` on the CPU, its launch replaced by the
  plain forward: gradients equal plain autograd's within 1e-6, ``.grad`` lands and
  accumulates on every weight, and the backward launches nothing (K4's: its backward
  kernel's launcher once, replaced by the closed-form plain backward).
- The optimizer against optax over 6 steps of fixed gradients (adam, sgd,
  rmsprop, a staircase schedule, gradient accumulation) within 1e-5 relative: the
  two round the same formula in another order (torch's Adam divides by the bias
  corrections in float64 on the host), a few ulps over six steps.
- One SGD ``make_train_step`` against the JAX one: the weights after the step
  within the gradient bar times the rate.
- ``remat_refiners``, ``disparity_metrics`` and ``idepth_to_disparity``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from multi_view_stereonet_tpu.geometry import idepth_to_disparity as jax_idepth_to_disparity
from multi_view_stereonet_tpu.losses import LossConfig as JaxLossConfig
from multi_view_stereonet_tpu.models import MultiViewStereoNetConfig as JaxConfig
from multi_view_stereonet_tpu.train import step as jax_step
from multi_view_stereonet_tpu.train.validation import disparity_metrics as jax_metrics
from multi_view_stereonet_tpu_torch.checkpoint import random_state_dict, state_dict_from_jax_params
from multi_view_stereonet_tpu_torch.geometry import idepth_to_disparity
from multi_view_stereonet_tpu_torch.losses import LossConfig
from multi_view_stereonet_tpu_torch.models import (
    FeatureRefiner, IDepthmapRefiner, MultiViewStereoNetConfig)
from multi_view_stereonet_tpu_torch.ops.cuda import gn_apply, recompute
from multi_view_stereonet_tpu_torch.ops.cuda import incremental_chain as chain
from multi_view_stereonet_tpu_torch.ops.cuda import refiner as refiner_op
from multi_view_stereonet_tpu_torch.ops.cuda import warp
from multi_view_stereonet_tpu_torch.train import step
from multi_view_stereonet_tpu_torch.train.validation import disparity_metrics

from tests.test_torch_cuda import rendered_pair
from tests.test_torch_model import JAX_PARITY, nhwc_inputs, weights

GRAD_BAR, COS_BAR, FLOOR = 2.5e-3, 1 - 2e-6, 1e-4
LOSS_BAR = 1e-5
WIRING_BAR = 1e-6
H, W = 64, 80


def make_batch(B, V, seed):
    """The loader's batch keys as numpy: images in [-1, 1], metric depths in [2, 10] m
    with ~10% of the left truth invalid (0), which the masked means must skip."""
    left, rights, K, T = nhwc_inputs(B, V, seed, H, W)
    rng = np.random.default_rng(seed + 100)
    depth = rng.uniform(2.0, 10.0, size=(B, H, W)).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.1] = 0.0
    return {"left_image": left, "right_images": rights, "K": K, "T_right_in_left": T,
            "left_depthmap_true": depth}


def tensors(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def port_loss_and_grads(model, batch, config, **kw):
    loss_fn = step.make_loss_fn(config, LossConfig(), **kw)
    model.zero_grad(set_to_none=True)
    loss, _ = loss_fn(model, tensors(batch))
    loss.backward()
    return loss.item(), {k: p.grad.numpy().copy() for k, p in model.named_parameters()}


def jax_loss_and_grads(params, batch, D):
    loss_fn = jax_step.make_loss_fn(JaxConfig(num_idepth_samples=D, **JAX_PARITY),
                                    JaxLossConfig())
    (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    grads = state_dict_from_jax_params(jax.tree.map(np.asarray, grads))
    return float(loss), {k: v.numpy() for k, v in grads.items()}


def assert_grads_close(got, ref, bar=GRAD_BAR):
    """Per leaf: max|diff| <= bar * max(max|ref|, floor) and, above the floor, the
    cosine; the floor is FLOOR times the largest reference leaf."""
    assert set(got) == set(ref)
    floor = FLOOR * max(float(np.abs(v).max()) for v in ref.values())
    worst = 0.0
    for k in sorted(ref):
        a, b = got[k], ref[k]
        assert a.shape == b.shape, k
        scale = max(float(np.abs(b).max()), floor)
        err = float(np.abs(a - b).max()) / scale
        worst = max(worst, err)
        assert err <= bar, f"{k}: {err:.3e} > {bar} (max|ref| {scale:.3e})"
        if float(np.abs(b).max()) > floor:
            cos = float(np.vdot(a, b)) / (np.linalg.norm(a) * np.linalg.norm(b))
            assert cos > COS_BAR, f"{k}: cosine {cos}"
    return worst


@pytest.mark.parametrize("B,V,D,seed", [(2, 2, 4, 20), (2, 1, 9, 20)])
def test_gradients_match_jax(B, V, D, seed):
    model, params = weights(seed)
    batch = make_batch(B, V, seed)
    ref_loss, ref = jax_loss_and_grads(params, batch, D)
    loss, got = port_loss_and_grads(model, batch, MultiViewStereoNetConfig(
        num_idepth_samples=D))
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, ref_loss, rtol=LOSS_BAR)
    assert_grads_close(got, ref)


@pytest.mark.parametrize("mode", ["unit", "full"])
def test_u8_transport_gives_the_f32_loss(mode):
    """uint8 images dequantized in the step give the loss of the host's float feed (the
    host pipeline: x / 255, then * 2 - 1 for "full") bit for bit."""
    model, _ = weights(20)
    batch = make_batch(1, 1, 20)
    rng = np.random.default_rng(5)
    u8 = {k: rng.integers(0, 256, size=batch[k].shape, dtype=np.uint8)
          for k in step.IMAGE_KEYS}
    f32 = {k: v.astype(np.float32) / 255.0 for k, v in u8.items()}
    if mode == "full":
        f32 = {k: v * 2.0 - 1.0 for k, v in f32.items()}
    config = MultiViewStereoNetConfig(num_idepth_samples=4)
    with torch.no_grad():
        got, _ = step.make_loss_fn(config, LossConfig(), transfer_u8=mode)(
            model, tensors({**batch, **u8}))
        ref, _ = step.make_loss_fn(config, LossConfig())(model, tensors({**batch, **f32}))
    assert torch.isfinite(ref) and got.item() == ref.item()
    with pytest.raises(TypeError, match="transfer_u8"):
        step.make_loss_fn(config, LossConfig(), transfer_u8=mode)(model, tensors(batch))


def test_a_training_step_after_an_inference_forward():
    """Validation runs under inference_mode, then training goes on at the same shapes:
    nothing the inference forward cached (the resize matrices) may be an inference
    tensor that the next backward would have to save."""
    model, _ = weights(20)
    batch = tensors(make_batch(1, 1, 21))
    loss_fn = step.make_loss_fn(MultiViewStereoNetConfig(num_idepth_samples=4), LossConfig())
    with torch.inference_mode():
        ref, _ = loss_fn(model, batch)
    loss, _ = loss_fn(model, batch)
    loss.backward()
    assert loss.item() == ref.item()
    assert all(p.grad is not None for p in model.parameters())


TWO_VIEW_FACTORS = dict(supervision_factor=1.0, left_right_factor=0.5, reconstruction_factor=0.5)


def test_two_view_gradients_match_jax():
    """The slice as a whole: the two-view recipe with every loss branch
    (estimate_right_idepthmap, supervision 1.0, left-right and reconstruction 0.5, the
    JAX package's all-loss case) on a rendered tilted-plane pair, B=1 64x80 D=4, seed 20
    weights: the loss, every loss dict entry and every parameter's gradient against
    ``jax.value_and_grad`` of the JAX ``make_loss_fn(multi_view=False,
    estimate_right_idepthmap=True)``, at the docs/PARITY.md:218-232 bar."""
    D = 4
    model, params = weights(20)
    batch = rendered_pair(1)
    loss_fn = jax_step.make_loss_fn(JaxConfig(num_idepth_samples=D, **JAX_PARITY),
                                    JaxLossConfig(**TWO_VIEW_FACTORS), multi_view=False,
                                    estimate_right_idepthmap=True)
    (ref_loss, ref_dict), ref = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    ref = {k: v.numpy() for k, v in state_dict_from_jax_params(
        jax.tree.map(np.asarray, ref)).items()}

    loss_fn = step.make_loss_fn(MultiViewStereoNetConfig(num_idepth_samples=D),
                                LossConfig(**TWO_VIEW_FACTORS), multi_view=False,
                                estimate_right_idepthmap=True)
    loss, loss_dict = loss_fn(model, tensors(batch))
    loss.backward()
    got = {k: p.grad.numpy().copy() for k, p in model.named_parameters()}
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=LOSS_BAR)
    assert set(loss_dict) == set(ref_dict)
    assert len(loss_dict["supervised_losses"]) == 11  # 5 left, the raw, 5 right
    assert len(loss_dict["reconstruction_losses"]) == 10
    assert float(ref_dict["left_right_loss"]) > 0  # the occlusion masks leave support
    for k, v in ref_dict.items():
        np.testing.assert_allclose([x.item() for x in loss_dict[k]] if isinstance(v, list)
                                   else loss_dict[k].item(), np.asarray(v), rtol=LOSS_BAR,
                                   err_msg=k)
    assert_grads_close(got, ref)


@pytest.mark.parametrize("mode", ["unit", "full"])
def test_u8_transport_gives_the_f32_loss_in_the_two_view_recipe(mode):
    """The two-view batch's left_image and right_image as uint8, dequantized in the step:
    the loss of the host's float feed bit for bit, every branch on."""
    model, _ = weights(20)
    batch = rendered_pair(1)
    rng = np.random.default_rng(6)
    u8 = {k: rng.integers(0, 256, size=batch[k].shape, dtype=np.uint8)
          for k in ("left_image", "right_image")}
    f32 = {k: v.astype(np.float32) / 255.0 for k, v in u8.items()}
    if mode == "full":
        f32 = {k: v * 2.0 - 1.0 for k, v in f32.items()}
    kw = dict(multi_view=False, estimate_right_idepthmap=True)
    config = MultiViewStereoNetConfig(num_idepth_samples=4)
    with torch.no_grad():
        got, _ = step.make_loss_fn(config, LossConfig(**TWO_VIEW_FACTORS), transfer_u8=mode,
                                   **kw)(model, tensors({**batch, **u8}))
        ref, _ = step.make_loss_fn(config, LossConfig(**TWO_VIEW_FACTORS), **kw)(
            model, tensors({**batch, **f32}))
    assert torch.isfinite(ref) and got.item() == ref.item()
    with pytest.raises(TypeError, match="transfer_u8"):
        step.make_loss_fn(config, LossConfig(**TWO_VIEW_FACTORS), transfer_u8=mode, **kw)(
            model, tensors(batch))


def test_remat_refiners_gives_the_same_gradients():
    model, _ = weights(20)
    batch = make_batch(1, 1, 20)
    loss, ref = port_loss_and_grads(model, batch, MultiViewStereoNetConfig(
        num_idepth_samples=4))
    loss_remat, got = port_loss_and_grads(model, batch, MultiViewStereoNetConfig(
        num_idepth_samples=4, remat_refiners=True))
    assert loss_remat == loss
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_sgd_train_step_matches_jax():
    lr = 0.1
    model, params = weights(20)
    batch = make_batch(2, 1, 20)
    D = 4
    tx = jax_step.make_optimizer(jax_step.OptimizerConfig(optimizer="sgd", learning_rate=lr))
    train_step = jax.jit(jax_step.make_train_step(
        JaxConfig(num_idepth_samples=D, **JAX_PARITY), JaxLossConfig(), tx))
    new_params, _, jax_loss, _ = train_step(params, tx.init(params),
                                            {k: jnp.asarray(v) for k, v in batch.items()})
    ref = {k: v.numpy() for k, v in state_dict_from_jax_params(
        jax.tree.map(np.asarray, new_params)).items()}

    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    optimizer = step.make_optimizer(step.OptimizerConfig(optimizer="sgd", learning_rate=lr),
                                    model.parameters())
    loss, loss_dict = step.make_train_step(
        MultiViewStereoNetConfig(num_idepth_samples=D), LossConfig(), optimizer)(
            model, tensors(batch))
    assert loss.grad_fn is None and "supervised_losses" in loss_dict
    np.testing.assert_allclose(loss.item(), float(jax_loss), rtol=LOSS_BAR)
    # Both steps moved the same weights by lr * g: the gap between them is lr times
    # the gap between the gradients, held to the gradient bar.
    got = {k: p.detach().numpy() for k, p in model.named_parameters()}
    moved = {k: (before[k].numpy() - ref[k]) / lr for k in ref}
    gap = {k: (before[k].numpy() - got[k]) / lr for k in ref}
    assert_grads_close(gap, moved)


# ---- the optimizers against optax ----

def _optax_run(tx, params, grads):
    state = tx.init(params)
    out = []
    for g in grads:
        updates, state = tx.update(g, state, params)
        params = optax.apply_updates(params, updates)
        out.append(jax.tree.map(np.asarray, params))
    return out


@pytest.mark.parametrize("config", [
    step.OptimizerConfig(optimizer="adam", learning_rate=1e-2),
    step.OptimizerConfig(optimizer="sgd", learning_rate=1e-2),
    step.OptimizerConfig(optimizer="rmsprop", learning_rate=1e-2),
    step.OptimizerConfig(optimizer="adam", learning_rate=1e-2, scheduler_gamma=0.5,
                         steps_per_epoch=3),
    step.OptimizerConfig(optimizer="adam", learning_rate=1e-2, scheduler_gamma=0.5,
                         steps_per_epoch=1, batches_per_step=2),
], ids=["adam", "sgd", "rmsprop", "schedule", "accumulate"])
def test_optimizer_matches_optax(config):
    rng = np.random.default_rng(0)
    init = {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) * 10 ** rng.uniform(-3, 1)
              for k, v in init.items()} for _ in range(6)]
    tx = jax_step.make_optimizer(jax_step.OptimizerConfig(**vars(config)))
    ref = _optax_run(tx, jax.tree.map(jnp.asarray, init), grads)

    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    optimizer = step.make_optimizer(config, params.values())
    applied = []
    for g, want in zip(grads, ref):
        optimizer.zero_grad()
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k].copy())
        applied.append(optimizer.step())
        for k, p in params.items():
            np.testing.assert_allclose(p.detach().numpy(), want[k], rtol=1e-5, atol=1e-6)
    assert applied == ([False, True] * 3 if config.batches_per_step == 2 else [True] * 6)

    # The optimizer's state round trips through its state dict.
    clone = step.make_optimizer(config, params.values())
    clone.load_state_dict(optimizer.state_dict())
    assert (clone.updates, clone.mini_step, clone.learning_rate()) == (
        optimizer.updates, optimizer.mini_step, optimizer.learning_rate())


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optimizer"):
        step.make_optimizer(step.OptimizerConfig(optimizer="lamb"),
                            [torch.nn.Parameter(torch.zeros(2))])


# ---- each kernel's autograd.Function, its launch replaced by the plain forward ----

def _plain_launch(monkeypatch, module, plain):
    """Replace ``module._launch`` with the plain forward; returns the call log."""
    calls = []

    def launch(*args):
        calls.append(len(args))
        return plain(*args)
    monkeypatch.setattr(module, "_launch", launch)
    return calls


def _check_function(run_kernel, run_plain, leaves, weights_, calls):
    """Gradients of the Function path equal plain autograd's; .grad lands and
    accumulates on every weight; one launch a forward, none in the backward; under
    no_grad the kernel is launched directly."""
    g = torch.Generator().manual_seed(7)
    out = run_plain()
    cot = torch.randn(out.shape, generator=g)
    ref = torch.autograd.grad((out * cot).sum(), leaves + weights_)
    for p in weights_:
        p.grad = None
    for _ in range(2):
        got = run_kernel()
        assert got.grad_fn is not None
        (got * cot).sum().backward()
    assert len(calls) == 2
    for leaf, r in zip(leaves, ref[:len(leaves)]):
        torch.testing.assert_close(leaf.grad, 2 * r, atol=WIRING_BAR, rtol=WIRING_BAR)
    for p, r in zip(weights_, ref[len(leaves):]):
        assert p.grad is not None
        torch.testing.assert_close(p.grad, 2 * r, atol=WIRING_BAR, rtol=WIRING_BAR)
    with torch.no_grad():
        assert run_kernel().grad_fn is None
    assert len(calls) == 3


def test_gn_function_recomputes_the_plain_version(monkeypatch):
    """K4's Function: its forward launch (replaced by the plain forward and the plain
    statistics) also returns the statistics, and its backward goes through the backward
    kernel's launcher (replaced by the closed-form plain backward), once a backward, with
    x, the weights, the conv bias and those statistics; the residual's gradient is the
    output's. Gradients equal plain autograd's through ``group_norm_act_plain``."""
    calls, backward_calls = [], []

    def launch(x, w, b, groups, res, xbias, stats=False):
        calls.append(stats)
        out = gn_apply.group_norm_act_plain(x, w, b, groups, res, xbias)
        return (out, gn_apply.group_stats_plain(x, groups, xbias)) if stats else out

    def launch_backward(*args):
        backward_calls.append(len(args))
        return gn_apply.group_norm_act_backward_plain(*args)
    monkeypatch.setattr(gn_apply, "_launch", launch)
    monkeypatch.setattr(gn_apply, "_launch_backward", launch_backward)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 32, 4, 6, generator=g, requires_grad=True)
    res = torch.randn(2, 32, 4, 6, generator=g, requires_grad=True)
    w = torch.nn.Parameter(1 + 0.1 * torch.randn(32, generator=g))
    b = torch.nn.Parameter(0.1 * torch.randn(32, generator=g))
    xb = torch.nn.Parameter(0.3 * torch.randn(32, generator=g))
    cot = torch.randn(x.shape, generator=g)
    with torch.no_grad():
        stats = gn_apply.group_stats_plain(x, 4, xb)
        ref = gn_apply.group_norm_act_backward_plain(x, w, b, 4, stats, cot, xb)
    for _ in range(2):
        got = gn_apply.group_norm_act_kernel(x, w, b, 4, res, xb)
        assert got.grad_fn is not None
        (got * cot).sum().backward()
    assert calls == [True, True] and backward_calls == [7, 7]
    for t, r in zip((x, w, b, xb, res), (*ref, cot)):
        torch.testing.assert_close(t.grad, 2 * r, atol=WIRING_BAR, rtol=WIRING_BAR)
    # ... which is plain autograd's gradient (the closed form against autograd:
    # tests/test_torch_gn_backward.py).
    out = gn_apply.group_norm_act_plain(x, w, b, 4, res, xb)
    auto = torch.autograd.grad((out * cot).sum(), (x, w, b, xb, res))
    for t, a in zip((x, w, b, xb, res), auto):
        assert (t.grad - 2 * a).abs().max() <= 2e-5 * a.abs().max()
    with torch.no_grad():
        assert gn_apply.group_norm_act_kernel(x, w, b, 4, res, xb).grad_fn is None
    assert calls == [True, True, False] and backward_calls == [7, 7]


def test_warp_function_recomputes_the_plain_version(monkeypatch):
    """K1's Function: its forward launch (replaced by the plain forward) once a forward, and
    its backward through the backward kernel's launcher (replaced by the closed-form plain
    backward) once a backward, with image, grid, the output's gradient, zero_invalid and
    the inputs that need a gradient. Gradients equal the closed form's, which is plain
    autograd's through ``grid_sample_plain`` (tests/test_torch_warp_backward.py)."""
    calls = _plain_launch(monkeypatch, warp, warp.grid_sample_plain)
    backward_calls = []

    def backward(*args):
        backward_calls.append(args[3:])
        return warp.grid_sample_backward_plain(*args)
    monkeypatch.setattr(warp, "grid_sample_backward", backward)
    g = torch.Generator().manual_seed(1)
    image = torch.randn(2, 6, 8, 3, generator=g, requires_grad=True)
    grid = (torch.rand(2, 5, 7, 2, generator=g) * 2.4 - 1.2).requires_grad_()
    cot = torch.randn(2, 5, 7, 3, generator=g)
    ref = warp.grid_sample_backward_plain(image.detach(), grid.detach(), cot, True)
    for _ in range(2):
        out = warp.grid_sample_kernel(image, grid, True)[0]
        assert out.grad_fn is not None
        (out * cot).sum().backward()
    assert len(calls) == 2 and backward_calls == [(True, (True, True))] * 2
    for t, r in zip((image, grid), ref):
        torch.testing.assert_close(t.grad, 2 * r, atol=WIRING_BAR, rtol=WIRING_BAR)
    out = warp.grid_sample_plain(image, grid, True)[0]
    for t, a in zip((image, grid), torch.autograd.grad((out * cot).sum(), (image, grid))):
        assert (t.grad - 2 * a).abs().max() <= 2e-5 * a.abs().max()
    with torch.no_grad():
        assert warp.grid_sample_kernel(image, grid, True)[0].grad_fn is None
    assert len(calls) == 3 and len(backward_calls) == 2


def _sub_state(prefix, seed=3):
    return {k[len(prefix):]: v for k, v in random_state_dict(seed).items()
            if k.startswith(prefix)}


def test_chain_function_routes_the_refiner_weights(monkeypatch):
    """K2's Function: its forward launch (replaced by the plain forward that also gives
    the kept raw maps and statistics, ``incremental_chain_saved_plain``) asks to keep
    them under autograd, and its backward goes through the backward kernel's launcher
    (replaced by the closed-form plain backward) once a backward, with what the forward
    kept. Gradients of feats0 and of every refiner weight land, accumulate and equal the
    closed form's, which is plain autograd's through ``incremental_chain_plain``
    (tests/test_torch_chain_backward.py); image_rest and H_inc, which need none, get
    none."""
    calls, backward_calls = [], []

    def launch(refiner, f, i, h, cluster, tf32, keep=False):
        calls.append(keep)
        if keep:
            return chain.incremental_chain_saved_plain(refiner, f, i, h, tf32)
        return chain.incremental_chain_plain(refiner, f, i, h)

    def launch_backward(refiner, image, H, weights, out, raw, stats, grad, needs, cluster,
                        tf32):
        backward_calls.append(tuple(needs))
        return chain.incremental_chain_backward_plain(refiner, out[:, 0], image, H, out, raw,
                                                      stats, grad, (*needs[:3], True), tf32)
    monkeypatch.setattr(chain, "_launch", launch)
    monkeypatch.setattr(chain, "_launch_backward", launch_backward)
    refiner = FeatureRefiner(32)
    refiner.load_state_dict(_sub_state("right_feature_extractor.refiner."))
    g = torch.Generator().manual_seed(2)
    feats0 = torch.randn(1, 5, 6, 32, generator=g, requires_grad=True)
    image_rest = torch.rand(1, 3, 5, 6, 3, generator=g)
    H_inc = (torch.eye(3) + 0.05 * torch.randn(1, 3, 3, 3, generator=g)).contiguous()
    params = list(refiner.parameters())
    cot = torch.randn(1, 4, 5, 6, 32, generator=g)
    with torch.no_grad():
        out, raw, stats = chain.incremental_chain_saved_plain(refiner, feats0, image_rest,
                                                              H_inc)
        d_feats0, _, _, d_params = chain.incremental_chain_backward_plain(
            refiner, feats0, image_rest, H_inc, out, raw, stats, cot)
    for _ in range(2):
        got = chain.incremental_chain_kernel(refiner, feats0, image_rest, H_inc)
        assert got.grad_fn is not None
        (got * cot).sum().backward()
    assert calls == [True, True]
    assert backward_calls == [(True, False, False) + (True,) * len(params)] * 2
    for t, r in zip([feats0, *params], [d_feats0, *d_params]):
        torch.testing.assert_close(t.grad, 2 * r, atol=WIRING_BAR, rtol=WIRING_BAR)
    plain = chain.incremental_chain_plain(refiner, feats0, image_rest, H_inc)
    auto = torch.autograd.grad((plain * cot).sum(), [feats0, *params])
    for t, a in zip([feats0, *params], auto):
        assert (t.grad - 2 * a).abs().max() <= 2e-5 * a.abs().max()
    assert image_rest.grad is None and H_inc.grad is None
    with torch.no_grad():
        assert chain.incremental_chain_kernel(refiner, feats0, image_rest, H_inc).grad_fn is None
    assert calls == [True, True, False] and len(backward_calls) == 2


def test_refiner_function_routes_the_refiner_weights(monkeypatch):
    calls = _plain_launch(monkeypatch, refiner_op,
                          lambda refiner, gd, i, tf32: refiner_op.idepthmap_refiner_plain(
                              refiner, gd, i))
    module = IDepthmapRefiner(35)
    module.load_state_dict(_sub_state("refiner3."))
    g = torch.Generator().manual_seed(4)
    guidance = torch.randn(2, 35, 6, 8, generator=g, requires_grad=True)
    idepth = (torch.rand(2, 6, 8, generator=g) * 20).requires_grad_()
    _check_function(lambda: refiner_op.idepthmap_refiner_kernel(module, guidance, idepth),
                    lambda: refiner_op.idepthmap_refiner_plain(module, guidance, idepth),
                    [guidance, idepth], list(module.parameters()), calls)


def test_plain_vjp_leaves_out_what_needs_no_grad():
    g = torch.Generator().manual_seed(5)
    a, b, c = (torch.randn(4, generator=g) for _ in range(3))
    cot = torch.randn(4, generator=g)

    def fn(a, b, c):
        return a * b + c.exp()
    got = recompute.plain_vjp(fn, (a, b, c), (True, False, True), (cot,))
    assert got[1] is None
    torch.testing.assert_close(got[0], cot * b)
    torch.testing.assert_close(got[2], cot * c.exp())
    assert recompute.plain_vjp(fn, (a, b, c), (False, False, False), (cot,)) == (
        None, None, None)


# ---- validation metrics ----

def _disparity_inputs(seed=0, B=2, rows=12, cols=16):
    from tests.test_model_parity import random_K, random_pose

    rng = np.random.default_rng(seed)
    K = np.stack([random_K(rows, cols) for _ in range(B)])
    T = np.stack([random_pose(rng, scale=0.8) for _ in range(B)])
    est = rng.uniform(0.05, 2.0, size=(B, rows, cols)).astype(np.float32)
    true = (est * rng.uniform(0.7, 1.3, size=est.shape)).astype(np.float32)
    true[rng.uniform(size=true.shape) < 0.2] = 0.0
    return K, T, est, true


def test_idepth_to_disparity_matches_jax():
    K, T, est, _ = _disparity_inputs()
    ref = np.asarray(jax_idepth_to_disparity(jnp.asarray(K), jnp.asarray(T), jnp.asarray(est)))
    got = idepth_to_disparity(torch.from_numpy(K), torch.from_numpy(T), torch.from_numpy(est))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_disparity_metrics_match_jax():
    K, T, est, true = _disparity_inputs(seed=1)
    with jax.default_matmul_precision("highest"):
        ref = {k: float(v) for k, v in jax_metrics(*map(jnp.asarray, (K, T, est, true))).items()}
    got = {k: float(v) for k, v in disparity_metrics(
        *map(torch.from_numpy, (K, T, est, true))).items()}
    assert list(got) == list(ref)
    assert 0.0 < ref["outlier_rate1"] < 1.0
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, err_msg=k)

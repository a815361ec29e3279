"""The port's losses and their pieces against the JAX package, on the CPU.

Inputs come from numpy seeds; the two-view scenes are rendered tilted-plane pairs
(``tests/test_torch_cuda.py`` ``rendered_pair``, B = 2 at 64x80), so the
occlusion-masked branches have support. Both sides run their plain gathers.

Bars:
- ops (``avg_pool_same``, the gradients, the blurs), ``unpack_batch`` and the
  ``stereo_warp`` predictors: max abs error <= 1e-5 * max(1, max|JAX|);
- losses and loss maps: max abs error <= 1e-5 * max|JAX| (1e-5 relative);
- gradients with respect to the losses' inputs, against ``jax.grad``: per input,
  max|diff| <= 1e-4 * max|JAX grad| and cosine > 0.99999. The losses sum thousands of
  terms whose float order differs between the two, and threshold on sampled values;
- occlusion masks: equal, or a flipped pixel only where JAX's margin |id_diff - thresh|
  is within float rounding of the threshold (2e-6 * max(1, thresh)); each flip is
  reported with its margin.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multi_view_stereonet_tpu import geometry as jgeo
from multi_view_stereonet_tpu import losses as jlosses
from multi_view_stereonet_tpu import ops as jops
from multi_view_stereonet_tpu.losses import consistency as jconsistency
from multi_view_stereonet_tpu.losses import regularizers as jregularizers
from multi_view_stereonet_tpu.ops import gradients as jgradients
from multi_view_stereonet_tpu.ops import stereo_warp as jstereo_warp
from multi_view_stereonet_tpu.train import pipeline as jpipeline
from multi_view_stereonet_tpu_torch import losses as tlosses
from multi_view_stereonet_tpu_torch import ops as tops
from multi_view_stereonet_tpu_torch.losses import consistency as tconsistency
from multi_view_stereonet_tpu_torch.losses import regularizers as tregularizers
from multi_view_stereonet_tpu_torch.ops import gradients as tgradients
from multi_view_stereonet_tpu_torch.ops import stereo_warp as tstereo_warp
from multi_view_stereonet_tpu_torch.ops.cuda import warp
from multi_view_stereonet_tpu_torch.train import pipeline as tpipeline

from tests.test_torch_cuda import rendered_pair

H, W = 64, 80
OP_BAR = 1e-5
LOSS_BAR = 1e-5
GRAD_BAR, GRAD_COS = 1e-4, 1 - 1e-5
TIE = 2e-6
ALL_FACTORS = dict(supervision_factor=1.0, left_right_factor=0.5, reconstruction_factor=0.5)


def tt(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def assert_loss_close(got, ref, bar=LOSS_BAR, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, what
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max()) / scale
    assert err <= bar, f"{what}: {err:.3e} of max|ref| {scale:.3e}"


def assert_grads_close(got, ref, what=""):
    for i, (a, b) in enumerate(zip(got, ref)):
        a, b = a.detach().numpy(), np.asarray(b)
        scale = float(np.abs(b).max())
        assert scale > 0, f"{what}[{i}]: no gradient to compare"
        err = float(np.abs(a - b).max()) / scale
        cos = float(np.vdot(a, b)) / (np.linalg.norm(a) * np.linalg.norm(b))
        assert err <= GRAD_BAR and cos > GRAD_COS, f"{what}[{i}]: {err:.3e}, cosine {cos}"


def torch_grads(fn, *arrays):
    leaves = [tt(a).requires_grad_() for a in arrays]
    out = fn(*leaves)
    out.backward()
    return out, [x.grad for x in leaves]


def scene_inputs(B=2, noise=0.02, seed=11):
    """(two-view batch, JAX inputs of its unpack, idepth pyramids left/right): each
    level the area-resized truth idepth times (1 + noise), invalid truth filled from its
    neighbours by the resize, so the predictions are positive everywhere."""
    batch = rendered_pair(B, seed)
    inputs = jpipeline.unpack_batch({k: jnp.asarray(v) for k, v in batch.items()})
    rng = np.random.default_rng(seed + 100)
    pyrs = {}
    for side in ("left", "right"):
        truth = np.asarray(inputs[f"{side}_idepthmap_true"])
        filled = np.where(truth > 0, truth, np.median(truth[truth > 0]))
        levels = []
        for image in inputs[f"{side}_image_pyr"]:
            lvl = np.asarray(jops.resize_area(jnp.asarray(filled), image.shape[1:3]))
            levels.append((lvl * (1 + noise * rng.normal(size=lvl.shape))).astype(np.float32))
        pyrs[side] = levels
    return batch, inputs, pyrs


def torch_inputs(inputs):
    return {k: [tt(np.asarray(x)) for x in v] if isinstance(v, list) else tt(np.asarray(v))
            for k, v in inputs.items()}


@pytest.mark.parametrize("name", ["avg_pool_same_nhwc", "avg_pool_same_nhw", "forward_gradx",
                                  "forward_grady", "central_gradx", "central_grady",
                                  "gaussian_blur", "blur_with_zeros"])
def test_pooling_gradients_and_blurs_match_jax(name):
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, size=(2, H - 1, W + 3, 3)).astype(np.float32)
    if name == "avg_pool_same_nhw":
        got, ref = tops.avg_pool_same(tt(x[..., 0]), 3), jops.avg_pool_same(jnp.asarray(x[..., 0]), 3)
    elif name == "avg_pool_same_nhwc":
        got, ref = tops.avg_pool_same(tt(x), 5), jops.avg_pool_same(jnp.asarray(x), 5)
    else:
        if name == "blur_with_zeros":
            x[:, 20:40, 30:60] = 0.0  # a hole wider than the kernel: 0 where nothing valid
        got = getattr(tgradients, name)(tt(x))
        ref = getattr(jgradients, name)(jnp.asarray(x))
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=OP_BAR * max(1.0, float(np.abs(ref).max())),
                               rtol=0, err_msg=name)


def test_masked_mean_or_zero_on_an_empty_mask():
    """The consistency losses' masked mean (the port's one ``masked_mean``) against the
    JAX module's ``_masked_mean_or_zero``."""
    x = tt(np.random.default_rng(2).uniform(size=(2, 5, 6)).astype(np.float32)).requires_grad_()
    empty = torch.zeros(2, 5, 6, dtype=torch.bool)
    out = tconsistency.masked_mean(x, empty)
    out.backward()
    ref = jconsistency._masked_mean_or_zero(jnp.asarray(x.detach().numpy()),
                                            jnp.zeros((2, 5, 6), bool))
    assert out.item() == float(ref) == 0.0
    assert torch.equal(x.grad, torch.zeros_like(x))
    full = torch.ones_like(empty)
    assert_loss_close(tconsistency.masked_mean(x, full), x.detach().mean().numpy())


def _photometric_case(name, rng):
    """(torch fn, JAX fn, input arrays) of a photometric or regularizer loss, scalar."""
    image = rng.uniform(-1, 1, size=(2, H, W, 3)).astype(np.float32)
    pred = np.clip(image + rng.normal(scale=0.3, size=image.shape), -1, 1).astype(np.float32)
    feats = rng.normal(size=(2, H // 2, W // 2, 8)).astype(np.float32)
    cot = rng.normal(size=image.shape).astype(np.float32)
    invalid = rng.uniform(size=(2, H, W)) < 0.2
    if name == "ssim":
        # A constant patch in both images: SSIM distance exactly 0, the clamp's tie.
        pred[0, :8, :8] = image[0, :8, :8] = 0.25
        return ((lambda x, y: (tlosses.ssim(x, y) * tt(cot)).sum()),
                (lambda x, y: (jlosses.ssim(x, y) * cot).sum()), (pred, image))
    if name == "reconstruction_photometric_loss":
        return ((lambda x, y: tlosses.reconstruction_photometric_loss(y, x, tt(invalid))),
                (lambda x, y: jlosses.reconstruction_photometric_loss(y, x,
                                                                      jnp.asarray(invalid))),
                (pred, image))
    if name == "smoothness_loss":
        out = rng.uniform(0, 1, size=(2, H, W, 1)).astype(np.float32)
        return ((lambda x, o: tlosses.smoothness_loss(x, o, 10.0)),
                (lambda x, o: jlosses.smoothness_loss(x, o, 10.0)), (image, out))
    if name == "corner_loss":
        return ((lambda f: tregularizers.corner_loss(f, 3)),
                (lambda f: jregularizers.corner_loss(f, 3)), (feats,))
    return ((lambda x, f: tregularizers.gradient_matching_loss(x, f)),
            (lambda x, f: jregularizers.gradient_matching_loss(x, f)),
            (image[:, ::2, ::2], feats))


@pytest.mark.parametrize("name", ["ssim", "reconstruction_photometric_loss",
                                  "smoothness_loss", "corner_loss", "gradient_matching_loss"])
def test_photometric_losses_and_regularizers_match_jax(name):
    """Value and gradients with respect to every input, against ``jax.value_and_grad``;
    ``ssim``'s map too."""
    fn, jfn, arrays = _photometric_case(name, np.random.default_rng(3))
    out, grads = torch_grads(fn, *arrays)
    ref, ref_grads = jax.value_and_grad(jfn, argnums=tuple(range(len(arrays))))(
        *[jnp.asarray(a) for a in arrays])
    assert_loss_close(out, ref, what=name)
    assert_grads_close(grads, ref_grads, what=name)
    if name == "ssim":
        got = tlosses.ssim(tt(arrays[0]), tt(arrays[1]))
        assert_loss_close(got, jlosses.ssim(*[jnp.asarray(a) for a in arrays]), what="ssim map")
        assert (got[0, 1:7, 1:7] == 0).all()


@jax.jit
def occlusion_mask(K, T, left, right):
    return jlosses.get_occlusion_mask(K, T, left, None, right, None)


def occlusion_margin(K, T, left, right):
    """JAX's id_diff - thresh of ``get_occlusion_mask`` (B, h, w)."""
    uv, id_prime, _ = jgeo.project_idepthmap(K, T, left)
    id_pred, _ = jops.grid_sample(right[..., None], uv)
    diff = id_pred[..., 0] - id_prime
    thresh = jnp.mean(jnp.abs(diff.reshape(diff.shape[0], -1)), axis=1)[:, None, None]
    return np.asarray(diff - thresh), np.asarray(thresh)


def assert_masks_equal_but_ties(got, ref, K, T, left, right, what):
    got, ref = got.numpy(), np.asarray(ref)
    flipped = got != ref
    assert 0 < ref.mean() < 1, f"{what}: the mask has no support ({ref.mean()})"
    if flipped.any():
        margin, thresh = occlusion_margin(K, T, left, right)
        tie = TIE * np.maximum(1.0, thresh)
        tie = np.broadcast_to(tie, margin.shape)
        print(f"{what}: {int(flipped.sum())} flipped pixels, JAX margins "
              f"{np.abs(margin[flipped]).tolist()}")
        assert (np.abs(margin[flipped]) <= tie[flipped]).all(), what


def test_occlusion_masks_match_jax():
    """Every refined level of the predictions, both directions, and the truth's."""
    _, inputs, pyrs = scene_inputs()
    for lvl in range(5):
        for (a, b), T in ((("left", "right"), inputs["T_right_in_left"]),
                          (("right", "left"), inputs["T_left_in_right"])):
            K = inputs["K_pyr"][lvl]
            left, right = jnp.asarray(pyrs[a][lvl]), jnp.asarray(pyrs[b][lvl])
            got = tlosses.get_occlusion_mask(tt(np.asarray(K)), tt(np.asarray(T)),
                                             tt(pyrs[a][lvl]), None, tt(pyrs[b][lvl]), None)
            ref = occlusion_mask(K, T, left, right)
            assert_masks_equal_but_ties(got, ref, K, T, left, right, f"{a} level {lvl}")
    K, T = inputs["K_pyr"][0], inputs["T_right_in_left"]
    left, right = inputs["left_idepthmap_true"], inputs["right_idepthmap_true"]
    got = tlosses.get_occlusion_mask(tt(np.asarray(K)), tt(np.asarray(T)),
                                     tt(np.asarray(left)), None, tt(np.asarray(right)), None)
    ref = occlusion_mask(K, T, left, right)
    assert_masks_equal_but_ties(got, ref, K, T, left, right, "truth")


@pytest.mark.parametrize("lvl", [0, 2, 4])
def test_reconstruction_loss_matches_jax(lvl):
    """The loss and predicted image; gradients with respect to the idepth and both
    images."""
    _, inputs, pyrs = scene_inputs()
    K0, T = np.asarray(inputs["K_pyr"][0]), np.asarray(inputs["T_right_in_left"])
    occ = np.asarray(occlusion_mask(inputs["K_pyr"][lvl], T, pyrs["left"][lvl],
                                    pyrs["right"][lvl]))
    left, right = np.asarray(inputs["left_image_pyr"][0]), np.asarray(inputs["right_image_pyr"][0])

    def port(idepth, left_image, right_image):
        loss, pred = tlosses.reconstruction_loss(tt(T), tt(K0), left_image, right_image,
                                                 idepth, tt(occ))
        port.pred = pred
        return loss

    def ref(idepth, left_image, right_image):
        return jlosses.reconstruction_loss(T, K0, left_image, right_image, idepth, occ)

    out, grads = torch_grads(port, pyrs["left"][lvl], left, right)
    (ref_out, ref_pred), ref_grads = jax.jit(jax.value_and_grad(ref, argnums=(0, 1, 2),
                                                                has_aux=True))(
        jnp.asarray(pyrs["left"][lvl]), jnp.asarray(left), jnp.asarray(right))
    assert_loss_close(out, ref_out, what="reconstruction loss")
    assert_loss_close(port.pred, ref_pred, what="predicted image")
    assert_grads_close(grads, ref_grads, what="reconstruction loss")


def test_left_right_consistency_loss_matches_jax():
    """The sum over five levels and both directions; gradients with respect to every
    level of both idepth pyramids."""
    _, inputs, pyrs = scene_inputs()
    K_pyr = [np.asarray(k) for k in inputs["K_pyr"]]
    T_rl, T_lr = np.asarray(inputs["T_right_in_left"]), np.asarray(inputs["T_left_in_right"])
    occ = {side: [np.asarray(occlusion_mask(K_pyr[lvl], T, pyrs[side][lvl], pyrs[other][lvl]))
                  for lvl in range(5)]
        for side, other, T in (("left", "right", T_rl), ("right", "left", T_lr))}

    def port(*levels):
        return tlosses.left_right_idepthmap_consistency_losses(
            tt(T_rl), tt(T_lr), [tt(k) for k in K_pyr], list(levels[:5]),
            [tt(m) for m in occ["left"]], list(levels[5:]), [tt(m) for m in occ["right"]])

    def ref(*levels):
        return jlosses.left_right_idepthmap_consistency_losses(
            T_rl, T_lr, K_pyr, list(levels[:5]), occ["left"], list(levels[5:]), occ["right"])

    arrays = pyrs["left"] + pyrs["right"]
    out, grads = torch_grads(port, *arrays)
    ref_out, ref_grads = jax.jit(jax.value_and_grad(ref, argnums=tuple(range(10))))(
        *[jnp.asarray(a) for a in arrays])
    assert float(ref_out) > 0
    assert_loss_close(out, ref_out, what="left-right loss")
    assert_grads_close(grads, ref_grads, what="left-right loss")


def outputs_of(pyrs):
    """Forward outputs made of the idepth pyramids (the raw ones the same)."""
    return {f"{side}_idepthmap{kind}_pyr": list(pyrs[side])
            for side in ("left", "right") for kind in ("", "_raw")}


def test_compute_losses_with_every_branch_matches_jax():
    """The total, every entry of the loss dict and every prediction (occlusion masks
    equal up to ties, predicted images within the loss bar)."""
    _, inputs, pyrs = scene_inputs()
    outputs = outputs_of(pyrs)
    loss, loss_dict, preds = tlosses.compute_losses(
        torch_inputs(inputs), torch_inputs(outputs), tlosses.LossConfig(**ALL_FACTORS))
    ref, ref_dict, ref_preds = jax.jit(lambda i, o: jlosses.compute_losses(
        i, o, jlosses.LossConfig(**ALL_FACTORS)))(
        inputs, {k: [jnp.asarray(x) for x in v] for k, v in outputs.items()})
    assert_loss_close(loss, ref, what="total")
    assert set(loss_dict) == set(ref_dict)
    for k, v in ref_dict.items():
        for got, want in zip(loss_dict[k] if isinstance(v, list) else [loss_dict[k]],
                             v if isinstance(v, list) else [v]):
            assert_loss_close(got, want, what=k)
    assert set(preds) == set(ref_preds)
    maps = {"left": dict(pyrs=pyrs["left"], true=inputs["left_idepthmap_true"],
                         T=inputs["T_right_in_left"], other="right"),
            "right": dict(pyrs=pyrs["right"], true=inputs["right_idepthmap_true"],
                          T=inputs["T_left_in_right"], other="left")}
    for k, v in ref_preds.items():
        got = preds[k] if isinstance(v, list) else [preds[k]]
        for lvl, want in enumerate(v if isinstance(v, list) else [v]):
            if "image" in k:
                assert_loss_close(got[lvl], want, what=f"{k}[{lvl}]")
                continue
            side = maps[k.split("_")[0]]
            other = maps[side["other"]]
            if k.endswith("_true"):
                left, right = side["true"], other["true"]
            else:
                left, right = jnp.asarray(side["pyrs"][lvl]), jnp.asarray(other["pyrs"][lvl])
            assert_masks_equal_but_ties(got[lvl], want, inputs["K_pyr"][lvl], side["T"],
                                        left, right, f"{k}[{lvl}]")


@pytest.mark.parametrize("factors", [dict(reconstruction_factor=0.5),
                                     dict(left_right_factor=0.5)],
                         ids=["reconstruction", "left_right"])
def test_compute_losses_names_the_right_view_outputs_it_needs(factors):
    """Without the two-view forward's outputs the JAX dispatcher fails with a KeyError on
    left_occlusion_mask_pyr; the port says what is missing."""
    _, inputs, pyrs = scene_inputs(B=1)
    outputs = {k: v for k, v in outputs_of(pyrs).items() if k.startswith("left")}
    with pytest.raises(KeyError, match="left_occlusion_mask_pyr"):
        jlosses.compute_losses(inputs, outputs, jlosses.LossConfig(**factors))
    with pytest.raises(ValueError, match="right_idepthmap_pyr"):
        tlosses.compute_losses(torch_inputs(inputs), torch_inputs(outputs),
                               tlosses.LossConfig(**factors))


def test_compute_losses_takes_impl_to_every_sample():
    """``impl`` reaches the losses' grid samples: "plain" gives the loss of "auto" on CPU
    tensors, and a name the samples do not know raises there."""
    _, inputs, pyrs = scene_inputs(B=1)
    args = (torch_inputs(inputs), torch_inputs(outputs_of(pyrs)),
            tlosses.LossConfig(**ALL_FACTORS))
    before = warp.launches
    assert tlosses.compute_losses(*args, impl="plain")[0] == tlosses.compute_losses(*args)[0]
    assert warp.launches == before
    with pytest.raises(ValueError, match="impl"):
        tlosses.compute_losses(*args, impl="fastest")


def test_unpack_batch_matches_jax():
    batch = rendered_pair(2)
    batch["T_right_in_left"][:, :3, 3] *= np.float32(3.5)  # a baseline of ~1.4
    got = tpipeline.unpack_batch({k: tt(v) for k, v in batch.items()})
    ref = jpipeline.unpack_batch({k: jnp.asarray(v) for k, v in batch.items()})
    assert set(got) == set(ref)
    for k, v in ref.items():
        for g, r in zip(got[k] if isinstance(v, list) else [got[k]],
                        v if isinstance(v, list) else [v]):
            r = np.asarray(r)
            np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                       atol=OP_BAR * max(1.0, float(np.abs(r).max())), err_msg=k)


def test_stereo_warp_predictors_match_jax():
    rng = np.random.default_rng(7)
    batch = rendered_pair(2)
    K, T = batch["K"], batch["T_right_in_left"]
    disp = rng.uniform(0.5, 9, size=(2, H, W)).astype(np.float32)
    image = batch["right_image"]
    T_flip = T.copy()
    T_flip[1, 0, 3] *= -1  # one pair shifts the other way
    for name, T_ in (("rectified_image_predictor", T_flip), ("disparity_image_predictor", T)):
        pred, invalid = getattr(tstereo_warp, name)(tt(K), tt(T_), tt(disp), tt(image))
        ref, ref_invalid = getattr(jstereo_warp, name)(jnp.asarray(K), jnp.asarray(T_),
                                                       jnp.asarray(disp), jnp.asarray(image))
        np.testing.assert_allclose(pred.numpy(), np.asarray(ref), atol=OP_BAR, rtol=0,
                                   err_msg=name)
        assert 0 < np.asarray(ref_invalid).mean() < 1
        assert (invalid.numpy() != np.asarray(ref_invalid)).mean() < 1e-3, name

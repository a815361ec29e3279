"""The port's bf16 serving path against the JAX package at bf16, on the CPU.

``compute_dtype`` / ``refiner_dtype`` / ``frontend_dtype`` resolve as the JAX
``_forward_impl`` resolves them off the TPU, and every module, each kernel's plain
version and the whole forward run at bf16 against the JAX functions at bf16 (JAX at
``JAX_PARITY``, as tests/test_torch_model.py runs it; inputs and weights from numpy
seeds). Then the CLIs: params.yaml's ``compute_dtype`` reaches the eval CLI's config,
``--bf16`` alone the streaming CLI's, ``export --dtype bfloat16`` round-trips bit-equal
to ``serving_forward`` at bf16, and the train CLI takes bf16 and refuses a dtype name
it does not know (bf16 training itself: tests/test_torch_bf16_train.py).

Bars:
- modules and the kernels' plain versions: max|got - ref| <= 2^-7 * max|ref| (one
  bf16 rounding of the largest value, twice), the incremental chain 2^-6 (its D - 1
  steps compound the roundings); the grid sample's bf16 output within one
  bf16 ulp of JAX's and bit-equal to the port's f32 output rounded; GroupNorm ->
  LeakyReLU (+ res) bit-equal;
- the whole forward, every level of both pyramids: max|got - ref| <= 1.5% and mean
  <= 0.5% of that level's range, masks equal on >= 99.9% of voxels. Both sides round at
  the same points, but JAX's CPU compiler drops some of them (XLA's excess precision:
  a bias add that feeds a GroupNorm is not rounded), and a flipped bf16 rounding moves
  the soft-argmin: the port lies as far from JAX at bf16 as JAX at bf16 lies from JAX
  at f32 (0.5-0.9% max, 0.1-0.4% mean of the range on these inputs).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from multi_view_stereonet_tpu.models import MultiViewStereoNetConfig as JaxConfig
from multi_view_stereonet_tpu.models import layers as jlayers
from multi_view_stereonet_tpu.models.cost_volume import cost_volume_filter as jax_cost_filter
from multi_view_stereonet_tpu.models.feature_network import feature_network as jax_features
from multi_view_stereonet_tpu.models.mvsnet import _incremental_scan
from multi_view_stereonet_tpu.models.refiners import (
    feature_refiner as jax_feature_refiner, idepthmap_refiner as jax_idepth_refiner)
from multi_view_stereonet_tpu.ops import warp as jwarp
from multi_view_stereonet_tpu_torch.checkpoint import export, random_state_dict
from multi_view_stereonet_tpu_torch.checkpoint.export import export_inference, load_exported
from multi_view_stereonet_tpu_torch.eval import streaming, test_cli
from multi_view_stereonet_tpu_torch.models import (
    MultiViewStereoNetConfig, resolve_dtypes)
from multi_view_stereonet_tpu_torch.ops import homography_warp_auto
from multi_view_stereonet_tpu_torch.ops.cuda import gn_apply
from multi_view_stereonet_tpu_torch.ops.cuda import incremental_chain as chain
from multi_view_stereonet_tpu_torch.ops.cuda import refiner as refiner_op
from multi_view_stereonet_tpu_torch.train import train_cli

from tests.synthetic_data import make_gta_sfm_tree
from tests.test_torch_kernels_plain import chain_inputs, refiner_pair
from tests.test_torch_model import (
    JAX_PARITY, KEYS, MASK_AGREEMENT, jax_model_forward, nhwc_inputs, port_model_forward,
    weights)

BF16 = torch.bfloat16
MODULE_BAR = 2.0 ** -7       # times max|ref|
# The chain compounds its steps' roundings: 0.93% of max|ref| measured at N=2, D=6,
# 16x24 against the scan (0.7-1.75% over the rounding variants tried, at D up to 12).
CHAIN_BAR = 2.0 ** -6
FORWARD_MAX, FORWARD_MEAN = 1.5e-2, 5e-3  # of each level's range
NAMES = ("float32", "bfloat16")
SIZE = (32, 48)
KEYS_IN = ("left_image", "right_images", "K", "T_right_in_left")


def as_np(x):
    """A tensor or a JAX array, at any float dtype, as an f32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def assert_close(got, ref, bar=MODULE_BAR):
    got, ref = as_np(got), as_np(ref)
    assert got.shape == ref.shape
    scale = float(np.abs(ref).max())
    err = float(np.abs(got - ref).max())
    assert scale > 0 and err <= bar * scale, f"{err:.3e} > {bar:.3e} * {scale:.3e}"


def bf16_ulp(x):
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


# ---- dtype resolution ----

def jax_rule_off_tpu(compute, refiner, frontend):
    """``_forward_impl``'s resolution (mvsnet.py:404-436) where the backend is not a
    TPU: "auto" is compute_dtype, a name is that dtype."""
    return tuple(getattr(torch, compute if name == "auto" else name)
                 for name in (compute, refiner, frontend))


@pytest.mark.parametrize("compute", NAMES)
@pytest.mark.parametrize("refiner", ("auto",) + NAMES)
@pytest.mark.parametrize("frontend", ("auto",) + NAMES)
def test_dtypes_resolve_as_jax_does_off_the_tpu(compute, refiner, frontend):
    config = MultiViewStereoNetConfig(compute_dtype=compute, refiner_dtype=refiner,
                                      frontend_dtype=frontend)
    assert resolve_dtypes(config) == jax_rule_off_tpu(compute, refiner, frontend)


def test_the_default_is_float32_and_a_bad_name_raises():
    assert resolve_dtypes(MultiViewStereoNetConfig()) == (torch.float32,) * 3
    for bad in ({"compute_dtype": "auto"}, {"compute_dtype": "float16"},
                {"refiner_dtype": "bf16"}, {"frontend_dtype": "half"}):
        with pytest.raises(ValueError, match="dtype"):
            resolve_dtypes(MultiViewStereoNetConfig(**bad))


# ---- modules at bf16 against JAX at bf16 ----

@pytest.mark.parametrize("module", ["resnet_block", "feature_network", "feature_refiner",
                                    "cost_volume_filter", "idepthmap_refiner"])
def test_modules_at_bf16_match_jax(module):
    model, params = weights(seed=11)
    rng = np.random.default_rng(13)
    bf = jnp.bfloat16
    with jax.default_matmul_precision("highest"), torch.no_grad():
        if module == "resnet_block":
            x = rng.normal(size=(2, 12, 16, 32)).astype(np.float32)
            got = model.refiner1.res1(torch.from_numpy(x).permute(0, 3, 1, 2).to(BF16))
            ref = jax.jit(lambda p, x: jlayers.resnet_block(p, x, dilation=2))(
                params["refiner1"]["res1"], jnp.asarray(x).astype(bf))
            assert got.dtype == BF16
            assert_close(got.permute(0, 2, 3, 1), ref)
        elif module == "feature_network":
            x = rng.uniform(-1, 1, size=(2, 48, 64, 3)).astype(np.float32)
            got = model.left_feature_extractor(torch.from_numpy(x).permute(0, 3, 1, 2).to(BF16))
            ref = jax.jit(jax_features)(params["feature_network"], jnp.asarray(x).astype(bf))
            for g, r in zip(got, ref):
                assert g.dtype == BF16
                assert_close(g.permute(0, 2, 3, 1), r)
        elif module == "feature_refiner":
            image = rng.uniform(-1, 1, size=(2, 12, 16, 3)).astype(np.float32)
            feats = rng.normal(size=(2, 12, 16, 32)).astype(np.float32)
            got = model.right_feature_extractor.refiner(
                torch.from_numpy(image).permute(0, 3, 1, 2).to(BF16),
                torch.from_numpy(feats).permute(0, 3, 1, 2).to(BF16))
            ref = jax.jit(jax_feature_refiner)(params["feature_refiner"],
                                               jnp.asarray(image).astype(bf),
                                               jnp.asarray(feats).astype(bf))
            assert got.dtype == BF16
            assert_close(got.permute(0, 2, 3, 1), ref)
        elif module == "cost_volume_filter":
            volume = np.abs(rng.normal(size=(2, 6, 4, 5, 32))).astype(np.float32)
            got = model.volume_filter4(torch.from_numpy(volume).permute(0, 4, 1, 2, 3).to(BF16))
            ref = jax.jit(jax_cost_filter)(params["volume_filter4"],
                                           jnp.asarray(volume).astype(bf))
            assert got.dtype == torch.float32  # the soft-argmin's input, its bias added in f32
            assert_close(got, ref)
        else:
            guidance = rng.uniform(-1, 1, size=(2, 12, 16, 35)).astype(np.float32)
            idepth = rng.uniform(0, 40, size=(2, 12, 16)).astype(np.float32)
            got = model.refiner2(torch.from_numpy(guidance).permute(0, 3, 1, 2),
                                 torch.from_numpy(idepth), dtype=BF16)
            ref = jax.jit(lambda p, g, i: jax_idepth_refiner(p, g, i, compute_dtype=bf))(
                params["refiner2"], guidance, idepth)
            assert got.dtype == torch.float32  # the residual add stays in the prior's f32
            assert_close(got, ref)


# ---- each kernel's plain version at bf16 against its JAX counterpart ----

def test_k1_plain_bf16_output_matches_jax_out_dtype():
    """The min-idepth warp's bf16 output: interpolated in f32, rounded once, so it is the
    f32 output rounded bit for bit (tests/test_fast_paths.py asserts the same in JAX), and
    within a bf16 ulp of ``homography_warp_auto(out_dtype=bf16)``."""
    rng = np.random.default_rng(5)
    image = rng.uniform(0, 1, size=(2, 32, 40, 3)).astype(np.float32)
    H = np.tile(np.eye(3, dtype=np.float32), (2, 1, 1))
    H[:, 0, 2] = [-2.3, 1.7]
    H[:, 1, 2] = [0.6, -1.1]
    H[:, 0, 0] = [1.02, 0.97]
    got, inv = homography_warp_auto(torch.from_numpy(image), torch.from_numpy(H),
                                    zero_invalid=True, out_dtype=BF16)
    f32, inv32 = homography_warp_auto(torch.from_numpy(image), torch.from_numpy(H),
                                      zero_invalid=True)
    assert got.dtype == BF16 and torch.equal(got, f32.to(BF16)) and torch.equal(inv, inv32)
    ref, inv_ref = jwarp.homography_warp_auto(jnp.asarray(image), jnp.asarray(H),
                                              zero_invalid=True, out_dtype=jnp.bfloat16)
    ref = as_np(ref)
    assert np.all(np.abs(as_np(got) - ref) <= bf16_ulp(ref))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(inv_ref))


@pytest.mark.parametrize("residual", [True, False])
def test_k4_plain_bf16_matches_jax_group_norm_leaky(residual):
    """``leaky_relu(group_norm(x16)) (+ r16)`` of the JAX layers, bit for bit."""
    rng = np.random.default_rng(6)
    x = (rng.normal(size=(2, 12, 16, 32)) * 2 + 0.5).astype(np.float32)
    r = rng.normal(size=(2, 12, 16, 32)).astype(np.float32)
    scale = (1 + 0.1 * rng.normal(size=32)).astype(np.float32)
    bias = (0.1 * rng.normal(size=32)).astype(np.float32)
    bf = jnp.bfloat16
    ref = jlayers.leaky_relu(jlayers.group_norm({"scale": scale, "bias": bias},
                                                jnp.asarray(x).astype(bf), 4))
    if residual:
        ref = ref + jnp.asarray(r).astype(bf)
    got = gn_apply.group_norm_act(
        torch.from_numpy(x).permute(0, 3, 1, 2).to(BF16), torch.from_numpy(scale),
        torch.from_numpy(bias), 4,
        torch.from_numpy(r).permute(0, 3, 1, 2).to(BF16) if residual else None)
    assert got.dtype == BF16
    np.testing.assert_array_equal(as_np(got.permute(0, 2, 3, 1)), as_np(ref))


def test_k2_plain_bf16_matches_incremental_scan():
    """The chain at bf16 (the scan's grid sample interpolating at bf16) against
    ``_incremental_scan`` on bf16 features."""
    N, D, h, w = 2, 6, 16, 24
    refiner, jparams = refiner_pair(seed=N)
    feats0, image_rest, H_inc = chain_inputs(N, D, h, w, seed=D)
    feats16 = jnp.asarray(feats0).astype(jnp.bfloat16)
    rest = jax.jit(_incremental_scan)(jparams, feats16, image_rest, H_inc)
    ref = np.concatenate([as_np(feats16)[:, None], as_np(rest)], axis=1)
    with torch.no_grad():
        got = chain.incremental_chain(refiner, torch.from_numpy(feats0).to(BF16),
                                      torch.from_numpy(image_rest), torch.from_numpy(H_inc))
    assert got.dtype == BF16 and got.shape == (N, D, h, w, 32)
    assert_close(got, ref, CHAIN_BAR)


def test_k3_plain_bf16_matches_jax_compute_dtype():
    model, params = weights(seed=12)
    rng = np.random.default_rng(14)
    guidance = rng.uniform(-1, 1, size=(2, 30, 40, 35)).astype(np.float32)
    idepth = rng.uniform(0, 20, size=(2, 30, 40)).astype(np.float32)
    with jax.default_matmul_precision("highest"), torch.no_grad():
        got = refiner_op.idepthmap_refiner(
            model.refiner4, torch.from_numpy(guidance).permute(0, 3, 1, 2).to(BF16),
            torch.from_numpy(idepth))
        ref = jax.jit(lambda p, g, i: jax_idepth_refiner(p, g, i,
                                                          compute_dtype=jnp.bfloat16))(
            params["refiner4"], guidance, idepth)
    assert got.dtype == torch.float32
    assert_close(got, ref)
    # The delta, what the bf16 path rounds, is held to the bar too.
    assert_close(got - torch.from_numpy(idepth), as_np(ref) - idepth)


# ---- the whole forward at bf16 against JAX at bf16 ----

def assert_forward_close_bf16(got, ref):
    for key in KEYS[:2]:
        for lvl in range(5):
            g, r = got[key][lvl], ref[key][lvl]
            assert g.shape == r.shape and g.dtype == np.float32, (key, lvl)
            span = float(r.max() - r.min())
            assert np.isfinite(g).all() and span > 0, (key, lvl)
            err = np.abs(g - r)
            assert err.max() <= FORWARD_MAX * span, \
                f"{key}[{lvl}]: max {err.max():.3e} > {FORWARD_MAX} * {span:.3e}"
            assert err.mean() <= FORWARD_MEAN * span, \
                f"{key}[{lvl}]: mean {err.mean():.3e} > {FORWARD_MEAN} * {span:.3e}"
    for lvl in range(5):
        g, r = got[KEYS[2]][lvl], ref[KEYS[2]][lvl]
        assert g.shape == r.shape and g.dtype == np.bool_
        assert np.mean(g == r) >= MASK_AGREEMENT, f"mask level {lvl}"


@pytest.mark.parametrize("seed,B,V,D,dtypes", [
    pytest.param(0, 1, 1, 4, {}, id="0-1-1-4"),
    pytest.param(1, 1, 2, 6, {}, id="1-1-2-6"),
    pytest.param(20, 2, 2, 4, {}, id="20-2-2-4"),
    pytest.param(0, 1, 1, 4, {"refiner_dtype": "float32"}, id="0-1-1-4-refiners_f32"),
    pytest.param(0, 1, 1, 4, {"frontend_dtype": "float32"}, id="0-1-1-4-frontend_f32"),
])
def test_forward_at_bf16_matches_jax(seed, B, V, D, dtypes):
    model, params = weights(seed)
    left, rights, K, T = nhwc_inputs(B, V, seed)
    ref = jax_model_forward(params, left, rights, K, T, JaxConfig(
        num_idepth_samples=D, compute_dtype="bfloat16", **dtypes, **JAX_PARITY))
    got = port_model_forward(model, left, rights, K, T, MultiViewStereoNetConfig(
        num_idepth_samples=D, compute_dtype="bfloat16", **dtypes))
    assert_forward_close_bf16(got, ref)


# ---- the CLIs ----

@pytest.fixture(scope="module")
def run_tree(tmp_path_factory):
    """(weights dir, data dir, split, params.yaml path) of a 32x48 GTA-SfM tree; the
    params.yaml sets compute_dtype bfloat16."""
    root = str(tmp_path_factory.mktemp("bf16_cli"))
    data_dir, split = make_gta_sfm_tree(os.path.join(root, "gta"), num_sequences=1,
                                        frames=3, rows=SIZE[0], cols=SIZE[1], comparisons=1)
    run_dir = os.path.join(root, "run")
    weights_dir = os.path.join(run_dir, "checkpoints", "epoch0000")
    os.makedirs(weights_dir)
    params = os.path.join(run_dir, "params.yaml")
    with open(params, "w") as f:
        yaml.safe_dump({"size": list(SIZE), "num_idepth_samples": 4,
                        "compute_dtype": "bfloat16"}, f)
    torch.save(random_state_dict(3), os.path.join(weights_dir, streaming.WEIGHTS_FILE))
    return weights_dir, data_dir, split, params


def test_eval_cli_reads_the_dtypes_from_params_yaml(run_tree, tmp_path, monkeypatch):
    """params.yaml's compute_dtype reaches the forward the eval CLI runs, which then
    writes its metric files."""
    weights_dir, data_dir, split, _ = run_tree
    seen = []
    forward = test_cli.mvsnet_forward

    def spy(model, *args):
        seen.append(args[4])
        return forward(model, *args)
    monkeypatch.setattr(test_cli, "mvsnet_forward", spy)
    out = str(tmp_path / "out")
    loss, _ = test_cli.run_eval(weights_dir, data_dir, split, out, device="cpu")
    assert seen and all(resolve_dtypes(c) == (BF16,) * 3 for c in seen)
    assert np.isfinite(loss) and "depth_metrics.txt" in os.listdir(out)


def test_streaming_cli_bf16_flag_sets_compute_dtype(run_tree, monkeypatch, capsys):
    weights_dir, data_dir, split, params = run_tree
    with open(params) as f:
        cfg = yaml.safe_load(f)
    f32_params = os.path.join(os.path.dirname(params), "params_f32.yaml")
    with open(f32_params, "w") as f:
        yaml.safe_dump({**cfg, "compute_dtype": "float32"}, f)
    configs = []

    class Runner:
        def __init__(self, model, model_config, **kwargs):
            configs.append(model_config)

        def run(self, dataset, batch_size, workers):
            return iter(())
    monkeypatch.setattr(streaming, "StreamingRunner", Runner)
    for path, flags in ((f32_params, []), (f32_params, ["--bf16"]), (params, [])):
        streaming.main([weights_dir, data_dir, split, "--params_yaml", path, "--device",
                        "cpu", *flags])
    # The JAX streaming CLI sets the dtype from --bf16 alone, not from params.yaml.
    assert [c.compute_dtype for c in configs] == ["float32", "bfloat16", "float32"]
    assert configs[0] == dataclasses.replace(configs[1], compute_dtype="float32")


def test_export_bf16_round_trips_bit_equal_to_serving_forward(tmp_path):
    model = streaming.MultiViewStereoNet()
    model.load_state_dict(random_state_dict(3))
    model.eval()
    config = MultiViewStereoNetConfig(num_idepth_samples=4, compute_dtype="bfloat16")
    left, rights, K, T = nhwc_inputs(1, 2, 8, H=SIZE[0], W=SIZE[1])
    args = tuple(torch.from_numpy(a) for a in (left, rights, K, T))
    refiner_op.invalidate_packed_weights()
    path = str(tmp_path / "bf16.pt2")
    export.save_exported(export_inference(model, config, batch_size=1, views=2, size=SIZE),
                         path)
    with torch.no_grad():
        live = streaming.serving_forward(model, dict(zip(KEYS_IN, args)), config)
    out = load_exported(path)(*args)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    assert torch.equal(out, live)


def test_export_cli_passes_the_dtype(run_tree, tmp_path, monkeypatch):
    weights_dir = run_tree[0]
    configs = []

    def fake_export(model, config, **kwargs):
        configs.append(config)
        return "exported"
    monkeypatch.setattr(export, "export_inference", fake_export)
    monkeypatch.setattr(export, "save_exported", lambda exported, path: open(path, "w").close())
    monkeypatch.setattr(export, "custom_ops", lambda exported: [])
    for dtype in NAMES:
        export.main([weights_dir, str(tmp_path / f"{dtype}.pt2"), "--dtype", dtype,
                     "--device", "cpu"])
    assert [c.compute_dtype for c in configs] == list(NAMES)


def test_export_fakes_give_the_dtypes_the_kernels_write():
    from torch._subclasses.fake_tensor import FakeTensorMode

    g = torch.Generator().manual_seed(4)
    image, grid = torch.randn(1, 6, 8, 3, generator=g), torch.rand(1, 6, 8, 2, generator=g)
    refiner = streaming.MultiViewStereoNet().right_feature_extractor.refiner
    res = refiner.res0
    vec = torch.stack([refiner.conv0.bias, refiner.bn0.weight, refiner.bn0.bias,
                       res.conv1.bias, res.bn1.weight, res.bn1.bias, refiner.conv_final.bias])
    module = streaming.MultiViewStereoNet().refiner4
    pack, dilations = refiner_op.packed_weights(module, BF16)
    x = torch.randn(1, 32, 4, 6, generator=g).to(BF16)
    cases = [
        (torch.ops.mvs_torch.grid_sample, (image, grid, True, BF16), (BF16, torch.bool)),
        (torch.ops.mvs_torch.group_norm_act, (x, torch.ones(32), torch.zeros(32), x, 4),
         (BF16,)),
        (torch.ops.mvs_torch.incremental_chain,
         (torch.randn(1, 4, 6, 32).to(BF16), torch.rand(1, 2, 4, 6, 3).to(BF16),
          torch.eye(3).expand(1, 2, 3, 3).contiguous(), chain._taps(refiner.conv0.weight),
          chain._taps(res.conv1.weight), chain._taps(refiner.conv_final.weight), vec, 0),
         (BF16,)),
        (torch.ops.mvs_torch.idepthmap_refiner,
         (torch.randn(1, 35, 4, 6).to(BF16), torch.rand(1, 4, 6), pack, list(dilations)),
         (torch.float32,)),
    ]
    with torch.no_grad():
        for op, args, dtypes in cases:
            with FakeTensorMode() as mode:
                out = op(*(mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
                           for a in args))
            out = out if isinstance(out, tuple) else (out,)
            assert tuple(o.dtype for o in out) == dtypes, op


def test_train_cli_takes_bf16_and_refuses_an_unknown_dtype(tmp_path):
    """The train CLI reads compute_dtype, as the JAX train CLI does, and trains at it;
    refiner_dtype and frontend_dtype stay "auto" whatever params.yaml says; a dtype
    name it does not know raises before any file is written."""
    from multi_view_stereonet_tpu_torch.train.config import load_params_yaml

    base = load_params_yaml(None)
    for key in ("compute_dtype", "refiner_dtype", "frontend_dtype"):
        config = train_cli.model_config_from_params({**base, key: "bfloat16"})
        want = (BF16,) * 3 if key == "compute_dtype" else (torch.float32,) * 3
        assert resolve_dtypes(config) == want, key
    config = train_cli.model_config_from_params({**base, "compute_dtype": "bfloat16",
                                                 "remat_refiners": True})
    assert config.remat_refiners and (config.refiner_dtype, config.frontend_dtype) == (
        "auto", "auto")
    for name in ("bf16", "float16"):
        cfg = {**base, "compute_dtype": name}
        with pytest.raises(ValueError, match="compute_dtype must be one of"):
            train_cli.model_config_from_params(cfg)
        with pytest.raises(ValueError, match="compute_dtype must be one of"):
            train_cli.train(cfg, str(tmp_path / "no_data"), "no_split.txt", "",
                            str(tmp_path / "run"), device="cpu")
        assert not (tmp_path / "run").exists()


# ---- K3's weight pack at bf16 ----

def test_k3_pack_key_holds_the_storage_dtype():
    """The parameters stay f32 at every storage dtype, so the key must name the dtype
    the pack is for: a bf16 pack is never served to the f32 kernel, and each dtype keeps
    its own."""
    module = streaming.MultiViewStereoNet().refiner3
    params = tuple(module.parameters())
    key16 = refiner_op._pack_key(params, module, BF16)
    key32 = refiner_op._pack_key(params, module, torch.float32)
    assert BF16 in key16 and key16 != key32
    pack16, _ = refiner_op.packed_weights(module, BF16)
    pack32, _ = refiner_op.packed_weights(module)
    assert pack32 is not pack16 and not torch.equal(pack32, pack16)
    assert torch.equal(pack32, refiner_op._pack(module)[0])
    assert torch.equal(pack16, refiner_op._pack(module, BF16)[0])
    assert refiner_op.packed_weights(module, BF16)[0] is pack16
    assert refiner_op.packed_weights(module)[0] is pack32
    # The bf16 pack holds (w rounded to bf16, 0) pairs in the f32 pack's layout.
    pairs = pack16[:-((3 + 3 * refiner_op.NUM_RES) * refiner_op.C + 1)].reshape(-1, 2)
    assert torch.equal(pairs[:, 0], pairs[:, 0].to(BF16).float()) and not pairs[:, 1].any()

"""The port's matmul-precision ladder (``matmul_precision`` / ``stage_precision``) on the
CPU, against the JAX package.

- Names: ``resolve_precision`` takes the names ``jax.default_matmul_precision`` takes
  ("default", "high", "highest" and the aliases "bfloat16", "tensorfloat32",
  "float32") and maps them as JAX computes them off the TPU: exact f32, except "high"
  and its alias, TF32. An unknown name raises ValueError on both sides.
- The CLIs: the eval and train CLIs read ``matmul_precision`` from params.yaml into the
  config as the JAX CLIs do; the streaming CLI reads none, as the JAX one.
- Routing: a spy records the cuDNN and cuBLAS TF32 flags at every conv of the forward
  and its backward (by the stage its weight belongs to), at the pinned ops (the
  resizes, the soft-argmin, the homographies) and the precision K2 and K3 are asked
  for, with the kernels' launches replaced by their plain versions so that the kernel
  path runs here. The table of ``resolve_precision``'s docstring holds, and the
  caller's flags are back after the forward and after the backward.
- Parity: on the CPU every precision is exact f32 (as JAX's CPU backend), so the
  forward at "high" and with a stage override is bit-equal to "highest" and within the
  f32 bar of the JAX forward at the same config (0.2% of each level's range,
  docs/PARITY.md:152-154); the gradient at "high" within docs/PARITY.md:218-232's bar.
- The plain versions of the 1xTF32 kernels: their operand rounding is round half away
  from zero on the low 13 bits (an independent numpy version), they equal the f32 plain
  versions bit for bit where every conv operand is already a TF32 value, and elsewhere
  differ from them by no more than TF32's bound.
- K3's pack per precision, and the artifact's precision record; a ``stage_precision``
  override held in the artifact (its convs as ``mvs_torch::convolution`` with their
  mode, bit-equal to the live forward), and no conv op without one.
"""

import os

import numpy as np
import pytest
import torch
import yaml

import jax

from multi_view_stereonet_tpu.eval import test_cli as jax_test_cli
from multi_view_stereonet_tpu.models import MultiViewStereoNetConfig as JaxConfig
from multi_view_stereonet_tpu.models import mvsnet_forward as jax_forward
from multi_view_stereonet_tpu.train import train_cli as jax_train_cli
from multi_view_stereonet_tpu_torch.checkpoint import export, random_state_dict
from multi_view_stereonet_tpu_torch.eval import streaming, test_cli
from multi_view_stereonet_tpu_torch.losses import LossConfig
from multi_view_stereonet_tpu_torch.models import (
    FeatureRefiner, IDepthmapRefiner, MultiViewStereoNetConfig, mvsnet, resolve_precision)
from multi_view_stereonet_tpu_torch.ops import precision
from multi_view_stereonet_tpu_torch.ops.cuda import incremental_chain as chain
from multi_view_stereonet_tpu_torch.ops.cuda import refiner as refiner_op
from multi_view_stereonet_tpu_torch.train import step, train_cli
from multi_view_stereonet_tpu_torch.train.config import load_params_yaml

from tests.synthetic_data import make_gta_sfm_tree
from tests.test_torch_kernels_plain import chain_inputs, refiner_pair
from tests.test_torch_model import (
    JAX_PARITY, KEYS, assert_forward_close, jax_model_forward, nhwc_inputs,
    port_model_forward, weights)
from tests.test_torch_train import (
    assert_grads_close, make_batch, port_loss_and_grads, tensors)

NAMES = {"default": "ieee", "bfloat16": "ieee", "highest": "ieee", "float32": "ieee",
         "high": "tf32", "tensorfloat32": "tf32"}
STAGES = ("extractor", "chain", "cost", "refiners", "warp")
# Relative error of a product of two TF32 values against the f32 product: each operand
# within 2^-11 of its value.
TF32_PRODUCT = 2.0 ** -10 + 2.0 ** -22
SIZE = (32, 48)


# ---- names ----

@pytest.mark.parametrize("name", sorted(NAMES))
def test_names_resolve_as_jax_computes_them_off_the_tpu(name):
    with jax.default_matmul_precision(name):  # a name JAX takes
        pass
    ambient, modes = resolve_precision(MultiViewStereoNetConfig(matmul_precision=name))
    assert ambient == NAMES[name] and modes == dict.fromkeys(STAGES, NAMES[name])


@pytest.mark.parametrize("name", ["HIGH", "fastest", "tf32"])
def test_an_unknown_name_raises_as_in_jax(name):
    """JAX's forward raises ValueError as it enters the precision; the port's config
    resolution, the CLIs' config readers and the forward raise ValueError too."""
    with pytest.raises(ValueError):
        jax_forward(None, None, None, None, None, JaxConfig(matmul_precision=name))
    config = MultiViewStereoNetConfig(matmul_precision=name)
    with pytest.raises(ValueError, match="matmul_precision must be one of"):
        resolve_precision(config)
    with pytest.raises(ValueError, match="matmul_precision must be one of"):
        mvsnet.mvsnet_forward(None, [None] * 5, None, torch.zeros(1, 1, 4, 4), None, config)
    cfg = {**load_params_yaml(None), "matmul_precision": name}
    for read in (streaming.model_config_from_params, train_cli.model_config_from_params):
        with pytest.raises(ValueError, match="matmul_precision must be one of"):
            read(cfg)


@pytest.mark.parametrize("stage", STAGES)
def test_a_stage_override_replaces_the_ambient_precision(stage):
    for ambient, override in (("highest", "high"), ("high", "highest")):
        got = resolve_precision(MultiViewStereoNetConfig(
            matmul_precision=ambient, stage_precision=((stage, override),)))
        want = {s: NAMES[override if s == stage else ambient] for s in STAGES}
        assert got == (NAMES[ambient], want)
    # An empty override is none, as the JAX forward's ``if p``; an unknown stage raises
    # (the JAX forward ignores it).
    assert resolve_precision(MultiViewStereoNetConfig(
        matmul_precision="high", stage_precision={stage: None}))[1][stage] == "tf32"
    with pytest.raises(ValueError, match="stage_precision stages"):
        resolve_precision(MultiViewStereoNetConfig(stage_precision=(("refiner", "high"),)))


# ---- the CLIs ----

@pytest.fixture(scope="module")
def run_tree(tmp_path_factory):
    """(weights dir, data dir, split, params.yaml path) of a 32x48 GTA-SfM tree whose
    params.yaml sets matmul_precision high."""
    root = str(tmp_path_factory.mktemp("precision_cli"))
    data_dir, split = make_gta_sfm_tree(os.path.join(root, "gta"), num_sequences=1,
                                        frames=3, rows=SIZE[0], cols=SIZE[1], comparisons=1)
    weights_dir = os.path.join(root, "run", "checkpoints", "epoch0000")
    os.makedirs(weights_dir)
    params = os.path.join(root, "run", "params.yaml")
    with open(params, "w") as f:
        yaml.safe_dump({"size": list(SIZE), "num_idepth_samples": 4,
                        "matmul_precision": "high"}, f)
    torch.save(random_state_dict(3), os.path.join(weights_dir, streaming.WEIGHTS_FILE))
    return weights_dir, data_dir, split, params


def jax_eval_config(monkeypatch, weights_dir, data_dir, split, output_dir):
    """The config the JAX eval CLI builds from params.yaml (the run stopped as it
    loads the weights)."""
    seen = []

    class Stop(Exception):
        pass

    def record(**kwargs):
        seen.append(JaxConfig(**kwargs))
        return seen[-1]

    def stop(*args):
        raise Stop
    monkeypatch.setattr(jax_test_cli, "MultiViewStereoNetConfig", record)
    monkeypatch.setattr(jax_test_cli, "load_any_params", stop)
    with pytest.raises(Stop):
        jax_test_cli.run_eval(weights_dir, data_dir, split, output_dir)
    return seen[0]


def test_eval_cli_reads_matmul_precision(run_tree, tmp_path, monkeypatch):
    """params.yaml's matmul_precision reaches the forward the eval CLI runs, as the
    JAX CLI reads it; the CLI then writes its metric files."""
    weights_dir, data_dir, split, _ = run_tree
    jax_config = jax_eval_config(monkeypatch, weights_dir, data_dir, split,
                                 str(tmp_path / "jax_out"))
    assert jax_config.matmul_precision == "high"
    seen = []
    forward = test_cli.mvsnet_forward

    def spy(model, *args):
        seen.append(args[4])
        return forward(model, *args)
    monkeypatch.setattr(test_cli, "mvsnet_forward", spy)
    out = str(tmp_path / "out")
    loss, _ = test_cli.run_eval(weights_dir, data_dir, split, out, device="cpu")
    assert seen and all(c.matmul_precision == "high" for c in seen)
    assert np.isfinite(loss) and "depth_metrics.txt" in os.listdir(out)


def test_train_cli_reads_matmul_precision():
    base = load_params_yaml(None)
    for name in ("high", "highest", None):
        cfg = dict(base) if name is None else {**base, "matmul_precision": name}
        want = jax_train_cli.build_train_step(cfg, 12)[0].matmul_precision
        model = streaming.MultiViewStereoNet()
        got = train_cli.build_train_step(cfg, 12, model, "plain")[0]
        assert got.matmul_precision == want == (name or "default")


def test_streaming_cli_reads_no_precision(run_tree, monkeypatch):
    """The JAX streaming CLI builds its config without matmul_precision; so does the
    port's, whatever params.yaml says."""
    weights_dir, data_dir, split, params = run_tree
    configs = []

    class Runner:
        def __init__(self, model, model_config, **kwargs):
            configs.append(model_config)

        def run(self, dataset, batch_size, workers):
            return iter(())
    monkeypatch.setattr(streaming, "StreamingRunner", Runner)
    streaming.main([weights_dir, data_dir, split, "--params_yaml", params, "--device", "cpu"])
    assert [c.matmul_precision for c in configs] == ["default"]


# ---- routing ----

def stage_of(model):
    """weight storage -> the stage whose convs use it."""
    prefixes = {"left_feature_extractor": "extractor", "right_feature_extractor": "chain",
                "volume_filter4": "cost", "refiner": "refiners"}
    return {p.data_ptr(): next(s for k, s in prefixes.items() if name.startswith(k))
            for name, p in model.named_parameters() if p.ndim > 1}


class Spy:
    """The flags (cuDNN TF32, cuBLAS TF32) at every conv of the forward and backward,
    by stage, at the pinned ops, the (dtype, tf32) K2 and K3 are launched at and the
    tf32 K2's backward kernel is launched at; the kernels' launches run their plain
    versions (K2's backward its closed form), so the kernel path runs on the CPU."""

    def __init__(self, monkeypatch, model):
        self.stages = stage_of(model)
        self.convs, self.pinned, self.k2, self.k3 = [], [], [], []
        self.k2_backward, self.k3_backward = [], []
        conv, backward = precision._conv, precision._conv_backward

        def flags():
            return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32

        def stage(weight):  # a bf16 conv's weight is a cast: no stage is known
            return self.stages.get(weight.data_ptr(), weight.dtype)

        def conv_spy(x, weight, *args):
            self.convs.append(("forward", stage(weight), flags()))
            return conv(x, weight, *args)

        def backward_spy(grad, x, weight, *args):
            self.convs.append(("backward", stage(weight), flags()))
            return backward(grad, x, weight, *args)
        monkeypatch.setattr(precision, "_conv", conv_spy)
        monkeypatch.setattr(precision, "_conv_backward", backward_spy)
        for name in ("resize_bilinear", "extract_idepthmap", "create_plane_sweep_homographies",
                     "incremental_homographies"):
            fn = getattr(mvsnet, name)
            monkeypatch.setattr(mvsnet, name, self._pinned(name, fn, flags))

        def k2(refiner, feats0, image_rest, H_inc, cluster, tf32, keep=False):
            self.k2.append((feats0.dtype, tf32, flags()))
            out = chain.incremental_chain_plain(refiner, feats0, image_rest, H_inc)
            if not keep:
                return out
            _, raw, stats = chain.incremental_chain_saved_plain(refiner, feats0, image_rest,
                                                                H_inc, tf32)
            return out, raw, stats

        def k2_backward(refiner, image_rest, H_inc, weights, out, raw, stats, grad, needs,
                        cluster, tf32):
            self.k2_backward.append(tf32)
            return chain.incremental_chain_backward_plain(
                refiner, out[:, 0], image_rest, H_inc, out, raw, stats, grad,
                (*needs[:3], any(needs[3:])), tf32)

        def k3(refiner, guidance, idepth, tf32, keep=False):
            self.k3.append((guidance.dtype, tf32, flags()))
            out = refiner_op.idepthmap_refiner_plain(refiner, guidance, idepth)
            if not keep:
                return out
            _, raw, stats = refiner_op.idepthmap_refiner_saved_plain(refiner, guidance, idepth,
                                                                     tf32)
            return out, (raw, stats, raw, None)

        def k3_backward(refiner, guidance, idepth, out, saved, grad, needs, tf32):
            self.k3_backward.append(tf32)
            return refiner_op.idepthmap_refiner_backward_plain(refiner, guidance, idepth, out,
                                                               *saved[:2], grad, needs, tf32)
        monkeypatch.setattr(chain, "_launch", k2)
        monkeypatch.setattr(chain, "_launch_backward", k2_backward)
        monkeypatch.setattr(refiner_op, "_launch", k3)
        monkeypatch.setattr(refiner_op, "_launch_backward", k3_backward)
        for module in (mvsnet, chain, refiner_op):  # the kernel path on CPU tensors
            monkeypatch.setattr(module, "use_kernel", lambda impl, t: impl != "plain")

    def _pinned(self, name, fn, flags):
        def spy(*args, **kwargs):
            self.pinned.append((name, flags()))
            return fn(*args, **kwargs)
        return spy


ROUTING = {"default": {}, "high": {"matmul_precision": "high"},
           "highest": {"matmul_precision": "highest"},
           **{f"{s} at high": {"matmul_precision": "highest",
                               "stage_precision": ((s, "high"),)} for s in STAGES},
           "bf16 at high": {"matmul_precision": "high", "compute_dtype": "bfloat16"},
           "high with remat": {"matmul_precision": "high", "remat_refiners": True}}


@pytest.mark.parametrize("case", sorted(ROUTING))
def test_each_stage_runs_at_its_precision(case, monkeypatch):
    """The convs of each stage, forward and backward, under cuDNN's TF32 exactly where
    the stage resolves to "tf32"; cuBLAS's TF32 off at every conv and pinned op; K2 and
    K3 asked for 1xTF32 where their stage is at "tf32" and launched at bf16 storage
    (their bf16 variant) at every precision under compute_dtype bfloat16; the caller's
    flags (both on here) back after the forward and after the backward. Under
    ``remat_refiners`` the backward's recompute runs the refiners at their precision
    again."""
    config = MultiViewStereoNetConfig(num_idepth_samples=4, **ROUTING[case])
    _, modes = resolve_precision(config)
    model, _ = weights(5)
    spy = Spy(monkeypatch, model)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    inputs = tensors(make_batch(1, 1, 5))
    from multi_view_stereonet_tpu_torch.train.pipeline import multi_view_unpack_batch
    unpacked = multi_view_unpack_batch(inputs, 5)
    out = mvsnet.mvsnet_forward(model, unpacked["left_image_pyr"], unpacked["K_pyr"],
                                unpacked["T_right_in_left"], unpacked["right_image_pyr"],
                                config)
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == (
        True, True)
    forward_convs = len(spy.convs)
    sum(x.sum() for x in out["left_idepthmap_pyr"]).backward()
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == (
        True, True)
    assert len(spy.convs) > forward_convs  # the backward's convs were seen
    seen = set()
    for kind, stage, (cudnn, cublas) in spy.convs:
        seen.add((kind, stage))
        assert not cublas, (kind, stage)
        if stage != torch.bfloat16:  # bf16 operands: cuDNN's TF32 flag plays no part
            assert cudnn == (modes[stage] == "tf32"), (kind, stage, cudnn)
    stages = ((torch.bfloat16,) if "bf16" in case
              else ("extractor", "chain", "cost", "refiners"))
    # The chain's backward is K2's backward kernel, which takes no conv of PyTorch's.
    assert {("forward", s) for s in stages} | {("backward", s) for s in stages
                                               if s != "chain"} <= seen
    assert ("backward", "chain") not in seen
    assert {n for n, _ in spy.pinned} == {"resize_bilinear", "extract_idepthmap",
                                          "create_plane_sweep_homographies",
                                          "incremental_homographies"}
    assert all(not cublas for _, (_, cublas) in spy.pinned)
    dtype = torch.bfloat16 if "bf16" in case else torch.float32
    assert [(d, t) for d, t, _ in spy.k2] == [(dtype, modes["chain"] == "tf32")]
    # K2's backward kernel once, at its forward's variant.
    assert spy.k2_backward == [t for _, t, _ in spy.k2]
    # Levels 4 to 1 are small enough for K3 at 64x80; level 0 is not. The remat's
    # recompute launches each again. K3's backward kernel once a level, at its variant.
    assert len(spy.k3) == (8 if config.remat_refiners else 4)
    assert all((d, t) == (dtype, modes["refiners"] == "tf32") for d, t, _ in spy.k3)
    assert spy.k3_backward == [modes["refiners"] == "tf32"] * 4
    for d, t, (cudnn, cublas) in spy.k2 + spy.k3:
        assert cudnn == t and not cublas
    if dtype == torch.bfloat16:  # the bf16 variants, whatever the precision
        assert chain._entry(dtype, True) == chain.ENTRIES[dtype]
        assert refiner_op._entry(dtype, True) == refiner_op.ENTRIES[dtype]
    else:
        assert chain._entry(dtype, True) == chain.TF32_ENTRY
        assert refiner_op._entry(dtype, True) == refiner_op.TF32_ENTRY


def test_the_train_step_runs_the_losses_exact(monkeypatch):
    """A train step at "high" with the caller's flags on: the forward's convs and their
    gradients at TF32, the losses and the update with both flags off; the flags back
    after the step."""
    model, _ = weights(6)
    spy = Spy(monkeypatch, model)
    losses = []
    compute = step.compute_losses

    def record(*args):
        losses.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
        return compute(*args)
    monkeypatch.setattr(step, "compute_losses", record)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    config = MultiViewStereoNetConfig(num_idepth_samples=4, matmul_precision="high")
    optimizer = step.make_optimizer(step.OptimizerConfig(optimizer="sgd"), model.parameters())
    train_step = step.make_train_step(config, LossConfig(), optimizer)
    loss, _ = train_step(model, tensors(make_batch(1, 1, 6)))
    assert np.isfinite(loss.item())
    assert losses == [(False, False)]
    assert {flags for kind, _, flags in spy.convs} == {(True, False)}
    assert {kind for kind, _, _ in spy.convs} == {"forward", "backward"}
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == (
        True, True)


# ---- parity with JAX ----

PARITY = {"high": {"matmul_precision": "high"},
          "refiners at high": {"matmul_precision": "highest",
                               "stage_precision": (("refiners", "high"),)}}


@pytest.fixture(scope="module")
def parity_case():
    """The weights, the inputs and the port's output at "highest" on them, which every
    case is held to."""
    model, params = weights(7)
    inputs = nhwc_inputs(1, 2, 7, 64, 80)
    exact = port_model_forward(model, *inputs, MultiViewStereoNetConfig(
        num_idepth_samples=4, matmul_precision="highest"))
    return model, params, inputs, exact


@pytest.mark.parametrize("case", sorted(PARITY))
def test_forward_at_a_precision_matches_jax(case, parity_case):
    """JAX at the same config (its plain paths, as tests/test_torch_model.py runs it)
    within the f32 bar; the port's output bit-equal to its "highest" output, since on
    the CPU every precision is exact, as it is in JAX."""
    model, params, (left, rights, K, T), exact = parity_case
    knobs = {**JAX_PARITY, **PARITY[case]}
    ref = jax_model_forward(params, left, rights, K, T,
                            JaxConfig(num_idepth_samples=4, **knobs))
    got = port_model_forward(model, left, rights, K, T, MultiViewStereoNetConfig(
        num_idepth_samples=4, **PARITY[case]))
    assert_forward_close(got, ref)
    for key in KEYS:
        assert all(np.array_equal(a, b) for a, b in zip(got[key], exact[key])), key


def test_gradient_at_high_matches_jax():
    from multi_view_stereonet_tpu.losses import LossConfig as JaxLossConfig
    from multi_view_stereonet_tpu.train import step as jax_step
    from multi_view_stereonet_tpu_torch.checkpoint import state_dict_from_jax_params

    model, params = weights(20)
    batch = make_batch(1, 2, 20)
    loss_fn = jax_step.make_loss_fn(
        JaxConfig(num_idepth_samples=4, **{**JAX_PARITY, "matmul_precision": "high"}),
        JaxLossConfig())
    (ref_loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, {k: jax.numpy.asarray(v) for k, v in batch.items()})
    ref = {k: v.numpy() for k, v in state_dict_from_jax_params(
        jax.tree.map(np.asarray, grads)).items()}
    loss, got = port_loss_and_grads(model, batch, MultiViewStereoNetConfig(
        num_idepth_samples=4, matmul_precision="high"))
    np.testing.assert_allclose(loss, float(ref_loss), rtol=1e-5)
    assert_grads_close(got, ref)


# ---- the plain versions of the 1xTF32 kernels ----

def numpy_tf32(x):
    """x rounded to 10 mantissa bits, half away from zero, in float64 arithmetic."""
    x = np.asarray(x, np.float64)
    _, e = np.frexp(x)  # |x| = m 2^e, m in [0.5, 1)
    ulp = np.ldexp(1.0, e - 11)
    return (np.sign(x) * np.floor(np.abs(x) / ulp + 0.5) * ulp).astype(np.float32)


def test_operand_rounding_is_half_away_from_zero_on_the_low_13_bits():
    rng = np.random.default_rng(0)
    x = rng.normal(size=100_000).astype(np.float32) * np.float32(10.0) ** rng.integers(
        -20, 20, size=100_000).astype(np.float32)
    bits = rng.integers(0, 2 ** 10, size=64).astype(np.uint32)
    # 1 + a random 10-bit mantissa, plus exactly half a TF32 ulp: a tie.
    halves = (np.uint32(0x3F800000) | (bits << np.uint32(13)) | np.uint32(0x1000)).view(
        np.float32)
    x = np.concatenate([x, halves, -halves, [0.0, -0.0, 1.0, 2.0 - 2.0 ** -12]]).astype(
        np.float32)
    got = precision.round_tf32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, numpy_tf32(x))
    assert not (got.view(np.uint32) & 0x1FFF).any()
    np.testing.assert_array_equal(got[len(x) - 4 - 128:len(x) - 4 - 64],
                                  numpy_tf32(halves))
    assert (np.abs(got[-4 - 128:-4 - 64]) > np.abs(halves)).all()  # away from zero


def tf32_values(t, rng, scale=1.0, step=2.0 ** -6):
    """A tensor of t's shape holding small dyadic values, every one a TF32 value."""
    return torch.from_numpy((np.round(rng.uniform(-scale, scale, t.shape) / step)
                             * step).astype(np.float32))


def on_tf32_values(module, rng):
    """``module`` with every weight a TF32 value, every GroupNorm's scale 0 and its
    shift a small dyadic value: every conv's input is then a TF32 value too."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if ".bn" in f".{name}":  # h = LeakyReLU(shift), the shift >= 0
                p.copy_(tf32_values(p, rng, 2.0).abs() if name.endswith("bias")
                        else torch.zeros_like(p))
            else:
                p.copy_(tf32_values(p, rng, 0.5))
    return module


def chain_case(seed):
    refiner, _ = refiner_pair(seed)
    feats0, image_rest, H_inc = chain_inputs(2, 5, 8, 12, seed)
    return refiner, torch.from_numpy(feats0), torch.from_numpy(image_rest), torch.from_numpy(
        H_inc)


def refiner_case(seed):
    module = IDepthmapRefiner(35)
    module.load_state_dict({k[len("refiner4."):]: v for k, v in random_state_dict(seed).items()
                            if k.startswith("refiner4.")})
    g = torch.Generator().manual_seed(seed)
    return (module.eval(), torch.rand(2, 35, 8, 12, generator=g) * 2 - 1,
            torch.rand(2, 8, 12, generator=g) * 20)


def test_tf32_plain_versions_equal_f32_where_operands_are_tf32_values():
    """K2 over one step of the identity warp (on an 8x16 map, whose grid round trip is
    exact: the warp copies) and K3: inputs, weights and every staged conv input TF32
    values (``on_tf32_values``), so rounding them changes nothing: bit-equal."""
    rng = np.random.default_rng(1)
    refiner = on_tf32_values(FeatureRefiner(32), rng)
    feats0 = tf32_values(torch.empty(2, 8, 16, 32), rng)
    image_rest = tf32_values(torch.empty(2, 1, 8, 16, 3), rng)
    H_inc = torch.eye(3).expand(2, 1, 3, 3).contiguous()
    with torch.no_grad():
        got = chain.incremental_chain_tf32_plain(refiner, feats0, image_rest, H_inc)
        ref = chain.incremental_chain_plain(refiner, feats0, image_rest, H_inc)
    assert torch.equal(got, ref) and not torch.equal(got[:, 1], feats0)
    module = on_tf32_values(IDepthmapRefiner(35), rng)
    guidance = tf32_values(torch.empty(2, 35, 8, 12), rng)
    idepth = tf32_values(torch.empty(2, 8, 12), rng, 8.0) + 10
    with torch.no_grad():
        got = refiner_op.idepthmap_refiner_tf32_plain(module, guidance, idepth)
        ref = refiner_op.idepthmap_refiner_plain(module, guidance, idepth)
    assert torch.equal(got, ref)


def test_a_tf32_conv_is_within_the_tf32_bound():
    """One conv of each kind the network runs, its operands rounded: within TF32's
    product bound of conv(|x|, |w|) (plus f32's sums) of the exact conv, and not equal."""
    g = torch.Generator().manual_seed(2)
    for module, shape in ((torch.nn.Conv2d(35, 32, 3, padding=2, dilation=2), (2, 35, 9, 11)),
                          (torch.nn.Conv2d(3, 32, 5, stride=2, padding=2), (1, 3, 16, 20)),
                          (torch.nn.Conv3d(32, 32, 3, padding=1), (1, 32, 4, 5, 6))):
        x = torch.randn(shape, generator=g)
        args = (module.stride, module.padding, module.dilation, module.groups)
        with torch.no_grad():
            with precision.scope("tf32_round"):
                got = precision.convolution(x, module.weight, module.bias, *args)
            exact = precision.convolution(x, module.weight, module.bias, *args)
            size = precision.convolution(x.abs(), module.weight.abs(), None, *args)
        err = (got - exact).abs()
        assert (err <= TF32_PRODUCT * size + 1e-6 * size.max()).all()
        assert not torch.equal(got, exact)


@pytest.mark.parametrize("kernel", ["K2", "K3"])
def test_tf32_plain_versions_stay_near_f32(kernel):
    """With seeded fan-in-scale weights the TF32-rounding plain versions lie within
    0.2% of max|f32| of the f32 plain versions: a few TF32 roundings (2^-11) through
    the GroupNorms, the chain's four steps compounding them."""
    if kernel == "K2":
        refiner, *args = chain_case(3)
        run_tf32 = lambda: chain.incremental_chain_tf32_plain(refiner, *args)  # noqa: E731
        run_f32 = lambda: chain.incremental_chain_plain(refiner, *args)  # noqa: E731
    else:
        module, *args = refiner_case(3)
        run_tf32 = lambda: refiner_op.idepthmap_refiner_tf32_plain(module, *args)  # noqa: E731
        run_f32 = lambda: refiner_op.idepthmap_refiner_plain(module, *args)  # noqa: E731
    with torch.no_grad():
        got, ref = run_tf32(), run_f32()
    err = (got - ref).abs().max().item()
    assert 0 < err <= 2e-3 * ref.abs().max().item()


# ---- K3's pack per precision ----

def test_k3_packs_are_kept_per_precision():
    """The 3xTF32 pack holds (hi, lo) pairs, the 1xTF32 pack (hi, 0); neither is served
    for the other, each is kept, and both are remade after a weight write."""
    module, _, _ = refiner_case(4)
    refiner_op.invalidate_packed_weights(module)
    exact, _ = refiner_op.packed_weights(module)
    tf32, _ = refiner_op.packed_weights(module, tf32=True)
    assert tf32 is not exact and not torch.equal(tf32, exact)
    assert refiner_op.packed_weights(module)[0] is exact
    assert refiner_op.packed_weights(module, tf32=True)[0] is tf32
    assert refiner_op.packed_weights(module, torch.bfloat16, tf32=True)[0] is \
        refiner_op.packed_weights(module, torch.bfloat16)[0]
    weights_end = -((3 + 3 * refiner_op.NUM_RES) * refiner_op.C + 1)
    pairs, exact_pairs = tf32[:weights_end].view(-1, 2), exact[:weights_end].view(-1, 2)
    assert torch.equal(pairs[:, 0], exact_pairs[:, 0]) and not pairs[:, 1].any()
    assert exact_pairs[:, 1].any()
    with torch.no_grad():
        module.conv0.weight.mul_(0.5)
    assert torch.equal(refiner_op.packed_weights(module, tf32=True)[0],
                       refiner_op._pack(module, tf32=True)[0])
    assert torch.equal(refiner_op.packed_weights(module)[0], refiner_op._pack(module)[0])
    assert not torch.equal(refiner_op.packed_weights(module, tf32=True)[0], tf32)


# ---- the artifact ----

def test_the_artifact_records_and_applies_its_precision(tmp_path, monkeypatch):
    """``export_inference`` records the resolved mode; ``load_exported`` runs each call in
    it (a spy on the scope) and gives the caller's flags back; the output equals the
    live forward."""
    model = streaming.MultiViewStereoNet()
    model.load_state_dict(random_state_dict(3))
    config = MultiViewStereoNetConfig(num_idepth_samples=4, matmul_precision="high")
    exported = export.export_inference(model, config, size=SIZE)
    assert exported.mvs_precision == "tf32"
    path = str(tmp_path / "high.pt2")
    export.save_exported(exported, path)
    modes = []
    enter = precision.scope.__enter__

    def spy(self):
        modes.append(self.mode)
        return enter(self)
    monkeypatch.setattr(precision.scope, "__enter__", spy)
    loaded = export.load_exported(path)
    assert loaded.mvs_precision == "tf32"
    args = export._example_inputs(1, 1, SIZE, False, "cpu")
    for ambient in (False, True):
        monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", ambient)
        modes.clear()
        out = loaded(*args)
        assert modes == ["tf32"] and torch.backends.cudnn.allow_tf32 == ambient
    with torch.no_grad():
        live = export.make_serving_fn(model, config)(*args)
    assert torch.equal(out, live)


def conv_nodes(exported) -> list:
    """(target, the model's top-level module whose weight it takes, its tf32 argument
    or None) of each conv in an exported graph."""
    params = exported.graph_signature.inputs_to_parameters
    return [(str(n.target), params[n.args[1].name].split(".")[1],
             n.args[7] if "mvs_torch" in str(n.target) else None)
            for n in exported.graph.nodes
            if n.op == "call_function" and "conv" in str(n.target)]


def test_the_artifact_holds_a_stage_override(tmp_path, monkeypatch):
    """("refiners", "high") at "highest": exactly the refiners' convs are the conv op
    with tf32 True, every other conv an aten conv; loaded where no card is, it runs at
    the ambient mode "ieee" with the refiners' convs under cuDNN's TF32 flag (a spy on
    every conv), gives the caller's flag back, and is bit-equal to the live forward
    with the caller's flag on and off."""
    import chip_smoke

    model = streaming.MultiViewStereoNet()
    model.load_state_dict(random_state_dict(3))
    config = MultiViewStereoNetConfig(num_idepth_samples=4, matmul_precision="highest",
                                      stage_precision=(("refiners", "high"),))
    exported = export.export_inference(model, config, size=SIZE)
    assert exported.mvs_precision == "ieee"
    assert export.custom_ops(exported) == ["mvs_torch::convolution"]
    nodes = conv_nodes(exported)
    refiners = {f"refiner{lvl}" for lvl in range(5)}
    assert {owner for _, owner, _ in nodes} == refiners | {
        "left_feature_extractor", "right_feature_extractor", "volume_filter4"}
    for target, owner, tf32 in nodes:
        if owner in refiners:
            assert (target, tf32) == ("mvs_torch.convolution.default", True), owner
        else:
            assert target.startswith("aten.conv"), (target, owner)
    path = str(tmp_path / "override.pt2")
    export.save_exported(exported, path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    loaded = export.load_exported(path)
    args = export._example_inputs(1, 1, SIZE, False, "cpu")
    with torch.no_grad():
        live = export.make_serving_fn(model, config)(*args)
    for ambient in (False, True):
        monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", ambient)
        assert torch.equal(loaded(*args), live)
        assert torch.backends.cudnn.allow_tf32 == ambient
        flags = chip_smoke.conv_flags(loaded, args)
        assert flags == {f"{'op' if owner in refiners else 'aten'} {owner}": [owner in refiners]
                         for _, owner, _ in nodes}


def test_an_artifact_without_a_stage_override_keeps_its_graph(monkeypatch):
    """No conv op where every stage is at the ambient mode: an override to that mode
    exports the graph, node for node, of the default config traced without
    ``ops.precision.exporting``."""
    model = streaming.MultiViewStereoNet()
    model.load_state_dict(random_state_dict(3))
    same = MultiViewStereoNetConfig(num_idepth_samples=4, matmul_precision="default",
                                    stage_precision=(("refiners", "highest"),))
    exported = export.export_inference(model, same, size=SIZE)
    assert exported.mvs_precision == "ieee" and export.custom_ops(exported) == []

    class Untouched:
        def __init__(self, mode):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False
    monkeypatch.setattr(precision, "exporting", Untouched)
    plain = export.export_inference(model, MultiViewStereoNetConfig(num_idepth_samples=4),
                                    size=SIZE)
    assert ([(n.op, str(n.target)) for n in exported.graph.nodes]
            == [(n.op, str(n.target)) for n in plain.graph.nodes])

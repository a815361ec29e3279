"""The port's serving artifact (``checkpoint/export.py``) and its custom ops, on the CPU.

At the JAX package's export test's size (``tests/test_export.py``: B = 1, V = 2,
32x48, D = 4), with seeded fan-in-scale weights:
- the artifact, exported (from empty caches), saved and loaded, is bit-equal to
  ``serving_forward``; exported between two eager forwards, which stay bit-equal;
- tracing keeps its fake tensors out of the resize matrices' and K3's pack caches,
  and uses what they already hold as constants of the graph;
- the u8 inputs and f16 output contract (B = 2, V = 1) bit-equal to
  ``StreamingRunner(device="cpu")``, f16 compared as bits;
- against the JAX artifact (``load_exported(...).call``) with the same weights:
  within 0.2% of the JAX output's range (docs/PARITY.md:152-154);
- a fresh process runs the artifact with no weights and without importing the port's
  ``models``;
- an artifact holding the port's custom ops refuses to load where they cannot build.
The custom ops: ``torch.library.opcheck`` for the two kernels with a CPU version (K1,
K4) and for the conv op of ``stage_precision`` artifacts (``ops/precision.py``), and
each kernel op's fake implementation against its plain version's output shapes and
dtypes.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from multi_view_stereonet_tpu.checkpoint import convert_reference_state_dict
from multi_view_stereonet_tpu.checkpoint import export as jax_export
from multi_view_stereonet_tpu.models import MultiViewStereoNetConfig as JaxConfig
from multi_view_stereonet_tpu_torch.checkpoint import (
    export_inference, load_exported, random_state_dict, save_exported)
from multi_view_stereonet_tpu_torch.checkpoint import export
from multi_view_stereonet_tpu_torch.eval.streaming import StreamingRunner, serving_forward
from multi_view_stereonet_tpu_torch.models import (
    FeatureRefiner, IDepthmapRefiner, MultiViewStereoNet, MultiViewStereoNetConfig)
from multi_view_stereonet_tpu_torch.ops import resize
from multi_view_stereonet_tpu_torch.ops.cuda import build, gn_apply
from multi_view_stereonet_tpu_torch.ops.cuda import incremental_chain as chain
from multi_view_stereonet_tpu_torch.ops.cuda import refiner as refiner_op
from multi_view_stereonet_tpu_torch.ops.cuda import warp

from tests.test_export import _inputs
from tests.test_torch_model import JAX_PARITY

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED, D, SIZE = 3, 4, (32, 48)
PARITY_BAR = 2e-3  # of the JAX output's range
KEYS = ("left_image", "right_images", "K", "T_right_in_left")


def model_and_config():
    model = MultiViewStereoNet()
    model.load_state_dict(random_state_dict(SEED))
    return model.eval(), MultiViewStereoNetConfig(num_idepth_samples=D)


def inputs(B=1, V=2):
    return tuple(torch.from_numpy(np.array(a))
                 for a in _inputs(B=B, V=V, H=SIZE[0], W=SIZE[1]))


def eager(model, config, args, **kwargs):
    with torch.no_grad():
        return serving_forward(model, dict(zip(KEYS, args)), config, **kwargs)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """(path, model, config): exported from empty caches, saved."""
    model, config = model_and_config()
    resize._device_matrices.clear()
    refiner_op.invalidate_packed_weights()
    path = str(tmp_path_factory.mktemp("export") / "serving.pt2")
    save_exported(export_inference(model, config, batch_size=1, views=2, size=SIZE), path)
    return path, model, config


def test_round_trip_is_bit_equal_to_serving_forward(artifact):
    path, model, config = artifact
    args = inputs()
    live = eager(model, config, args)
    assert live.shape == (1, *SIZE) and torch.isfinite(live).all()
    loaded = load_exported(path)
    assert export.custom_ops(torch.export.load(path)) == []  # CPU: the plain versions
    out = loaded(*args)
    assert out.dtype == torch.float32 and not out.requires_grad
    assert torch.equal(out, live)


def test_u8_f16_contract_is_bit_equal_to_the_runner(tmp_path):
    """Exported between two eager forwards of the runner, which stay bit-equal."""
    model, config = model_and_config()
    rng = np.random.default_rng(3)
    B, V = 2, 1
    _, _, K, T = inputs(B, V)
    batch = {"left_image": rng.integers(0, 256, (B, *SIZE, 3), dtype=np.uint8),
             "right_images": rng.integers(0, 256, (B, V, *SIZE, 3), dtype=np.uint8),
             "K": K.numpy(), "T_right_in_left": T.numpy()}
    runner = StreamingRunner(model, config, device="cpu", fetch_dtype=torch.float16)
    before = runner.forward(batch)
    assert before.dtype == torch.float16
    path = str(tmp_path / "u8.pt2")
    save_exported(export_inference(model, config, batch_size=B, views=V, size=SIZE,
                                   input_u8=True, fetch_dtype=torch.float16), path)
    out = load_exported(path)(*(torch.from_numpy(batch[k]) for k in KEYS))
    after = runner.forward(batch)
    assert out.dtype == torch.float16
    assert torch.equal(out.view(torch.int16), before.view(torch.int16))
    assert torch.equal(after.view(torch.int16), before.view(torch.int16))


def test_artifact_agrees_with_the_jax_artifact(artifact, tmp_path):
    path, _, _ = artifact
    params = convert_reference_state_dict(
        {k: v.numpy() for k, v in random_state_dict(SEED).items()})
    jax_path = str(tmp_path / "model.jaxexport")
    jax_export.save_exported(jax_export.export_inference(
        params, JaxConfig(num_idepth_samples=D, **JAX_PARITY), batch_size=1, views=2,
        size=SIZE), jax_path)
    args = inputs()
    ref = np.asarray(jax_export.load_exported(jax_path).call(*(a.numpy() for a in args)))
    got = load_exported(path)(*args).numpy()
    assert got.shape == ref.shape and np.isfinite(ref).all()
    err = float(np.abs(got - ref).max())
    assert err <= PARITY_BAR * float(ref.max() - ref.min()), err


def test_fresh_process_runs_the_artifact_without_the_models(artifact, tmp_path):
    path, model, config = artifact
    args = inputs()
    np.savez(tmp_path / "io.npz", *(a.numpy() for a in args),
             live=eager(model, config, args).numpy())
    code = (
        "import sys, numpy as np, torch\n"
        "from multi_view_stereonet_tpu_torch.checkpoint.export import load_exported\n"
        f"io = np.load({str(tmp_path / 'io.npz')!r})\n"
        f"out = load_exported({path!r})(*(torch.from_numpy(io[f'arr_{{i}}']) "
        "for i in range(4)))\n"
        "assert np.array_equal(out.numpy(), io['live'])\n"
        "assert 'multi_view_stereonet_tpu_torch.models' not in sys.modules\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.split()[-1] == "ok", proc.stderr[-2000:]


def _targets(exported):
    return {str(n.target) for n in exported.graph.nodes if n.op == "call_function"}


class _Resize(torch.nn.Module):
    def forward(self, x):
        return resize.resize_bilinear(x, (7, 9))


class _Pack(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.refiner = IDepthmapRefiner(35)

    def forward(self, x):
        return refiner_op.packed_weights(self.refiner)[0] + x


def test_tracing_keeps_fake_tensors_out_of_the_caches():
    """Traced before any eager call, a resize and K3's pack are traced and nothing is
    cached; after an eager call the cached tensors are the graph's constants (nothing
    makes them at a call); after a parameter changes in place, the pack is traced from
    the parameters again. Every graph computes the eager values."""
    x = torch.rand(1, 4, 6, 3)
    resize._device_matrices.clear()
    first = torch.export.export(_Resize(), (x,), strict=False)
    assert not resize._device_matrices
    eager = resize.resize_bilinear(x, (7, 9))
    assert len(resize._device_matrices) == 2
    second = torch.export.export(_Resize(), (x,), strict=False)
    assert "aten.lift_fresh_copy.default" in _targets(first)
    assert "aten.lift_fresh_copy.default" not in _targets(second)
    for exported in (first, second):
        assert torch.equal(exported.module()(x), eager)

    module, zero = _Pack(), torch.zeros(())
    refiner_op.invalidate_packed_weights()
    with torch.no_grad():  # as export_inference traces
        traced = torch.export.export(module, (zero,), strict=False)
        assert module.refiner not in refiner_op._packs
        live = refiner_op.packed_weights(module.refiner)[0]
        constant = torch.export.export(module, (zero,), strict=False)
    assert "aten.gather.default" in _targets(traced)
    assert "aten.gather.default" not in _targets(constant)
    for exported in (traced, constant):
        assert torch.equal(exported.module()(zero), live)
    with torch.no_grad():
        module.refiner.conv0.weight.mul_(2)
        again = torch.export.export(module, (zero,), strict=False)
    assert "aten.gather.default" in _targets(again)
    assert torch.equal(again.module()(zero), refiner_op._pack(module.refiner)[0])


class _SampleOnly(torch.nn.Module):
    def forward(self, image, grid):
        return torch.ops.mvs_torch.grid_sample(image, grid, True)


def test_a_card_artifact_refuses_to_load_without_its_kernels(tmp_path, monkeypatch):
    """A graph holding a port custom op (here K1's, exported through its CPU version)
    needs the card's kernels: with no card, loading raises; nothing falls back."""
    g = torch.Generator().manual_seed(0)
    exported = torch.export.export(_SampleOnly(), (torch.rand(1, 6, 8, 3, generator=g),
                                                   torch.rand(1, 5, 7, 2, generator=g)))
    assert export.custom_ops(exported) == ["mvs_torch::grid_sample"]
    path = str(tmp_path / "k1.pt2")
    save_exported(exported, path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="exported on a card"):
        load_exported(path)


def test_export_cli_refuses_bfloat16(tmp_path):
    """bfloat16 is served now (tests/test_torch_bf16.py exports it); what the CLI still
    refuses, before it writes anything, is a dtype the port does not compute in."""
    with pytest.raises(SystemExit):
        export.main([str(tmp_path), str(tmp_path / "x.pt2"), "--dtype", "float16"])
    assert not (tmp_path / "x.pt2").exists()


@pytest.mark.slow
def test_export_cli(tmp_path):
    """weights dir (the port's .pth) -> artifact file on the CPU, at the default eval
    config's D = 12."""
    weights_dir = tmp_path / "weights"
    weights_dir.mkdir()
    torch.save(random_state_dict(SEED), str(weights_dir / "stereo_network.pth"))
    out = str(tmp_path / "model.pt2")
    export.main([str(weights_dir), out, "--size", *map(str, SIZE), "--views", "1",
                 "--device", "cpu"])
    res = load_exported(out)(*inputs(V=1))
    assert res.shape == (1, *SIZE) and torch.isfinite(res).all()


# ---- the custom ops ----

def test_the_four_kernels_are_custom_ops():
    assert build.OP_SOURCES == {
        "mvs_torch::grid_sample": "warp", "mvs_torch::incremental_chain": "incremental_chain",
        "mvs_torch::idepthmap_refiner": "idepthmap_refiner",
        "mvs_torch::group_norm_act": "gn_apply"}
    for name in build.OP_SOURCES:
        assert hasattr(torch.ops.mvs_torch, name.split("::")[1])


def _gn_case(shape, residual):
    g = torch.Generator().manual_seed(len(shape))
    x = torch.randn(shape, generator=g)
    C = shape[1]
    return (x, 1 + 0.1 * torch.randn(C, generator=g), 0.1 * torch.randn(C, generator=g),
            torch.randn(shape, generator=g) if residual else None, C // 8)


@pytest.mark.parametrize("case", ["k1_image", "k1_sweep", "k4_res", "k4_5d", "conv_tf32",
                                  "conv3d"])
def test_opcheck_on_the_cpu(case):
    g = torch.Generator().manual_seed(1)
    args = {"k1_image": lambda: (torch.randn(2, 6, 8, 3, generator=g),
                                 torch.rand(2, 5, 7, 2, generator=g) * 2.4 - 1.2, True),
            "k1_sweep": lambda: (torch.randn(1, 6, 8, 3, generator=g),
                                 torch.rand(1, 4, 6, 8, 2, generator=g) * 2.4 - 1.2, False),
            "k4_res": lambda: _gn_case((2, 32, 4, 6), True),
            "k4_5d": lambda: _gn_case((1, 32, 3, 4, 5), False),
            # A dilated, strided refiner-like conv with its bias; the cost filter's conv3d.
            "conv_tf32": lambda: (torch.randn(2, 35, 9, 11, generator=g),
                                  torch.randn(32, 35, 3, 3, generator=g),
                                  torch.randn(32, generator=g), [2, 1], [2, 2], [2, 2], 1,
                                  True),
            "conv3d": lambda: (torch.randn(1, 4, 5, 6, 7, generator=g),
                               torch.randn(4, 4, 3, 3, 3, generator=g), None, [1, 1, 1],
                               [1, 1, 1], [1, 1, 1], 1, False)}[case]()
    op = {"k1": torch.ops.mvs_torch.grid_sample, "k4": torch.ops.mvs_torch.group_norm_act,
          "co": torch.ops.mvs_torch.convolution}[case[:2]].default
    torch.library.opcheck(op, args)


def _fake_matches(op, args, ref):
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode() as mode:
        fake = op(*(mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args))
    ref = ref if isinstance(ref, tuple) else (ref,)
    fake = fake if isinstance(fake, tuple) else (fake,)
    assert [(f.shape, f.dtype, f.stride()) for f in fake] == [
        (r.shape, r.dtype, r.contiguous().stride()) for r in ref]


def test_fake_implementations_give_the_plain_shapes():
    g = torch.Generator().manual_seed(2)
    image, grid = torch.randn(2, 6, 8, 3, generator=g), torch.rand(2, 4, 5, 7, 2, generator=g)
    _fake_matches(torch.ops.mvs_torch.grid_sample, (image, grid, True),
                  warp.grid_sample_plain(image, grid, True))
    args = _gn_case((2, 32, 3, 4, 5), True)
    _fake_matches(torch.ops.mvs_torch.group_norm_act, args,
                  gn_apply.group_norm_act_plain(*args[:3], args[4], args[3]))

    refiner = FeatureRefiner(32)
    feats0 = torch.randn(2, 5, 6, 32, generator=g)
    image_rest = torch.rand(2, 3, 5, 6, 3, generator=g)
    H_inc = torch.eye(3).expand(2, 3, 3, 3).contiguous()
    res = refiner.res0
    vec = torch.stack([refiner.conv0.bias, refiner.bn0.weight, refiner.bn0.bias,
                       res.conv1.bias, res.bn1.weight, res.bn1.bias, refiner.conv_final.bias])
    with torch.no_grad():
        _fake_matches(torch.ops.mvs_torch.incremental_chain,
                      (feats0, image_rest, H_inc, chain._taps(refiner.conv0.weight),
                       chain._taps(res.conv1.weight), chain._taps(refiner.conv_final.weight),
                       vec, 0),
                      chain.incremental_chain_plain(refiner, feats0, image_rest, H_inc))

    module = IDepthmapRefiner(35)
    guidance, idepth = torch.randn(3, 35, 6, 8, generator=g), torch.rand(3, 6, 8, generator=g)
    pack, dilations = refiner_op.packed_weights(module)
    assert pack.shape == (refiner_op.packed_floats(36),)
    with torch.no_grad():
        _fake_matches(torch.ops.mvs_torch.idepthmap_refiner,
                      (guidance, idepth, pack, list(dilations)),
                      refiner_op.idepthmap_refiner_plain(module, guidance, idepth))

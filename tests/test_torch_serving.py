"""The port's serving path on the CPU against the JAX package, and its import surface.

- ``serving_forward`` / ``StreamingRunner`` over a synthetic GTA-SfM tree at
  64x80 against the JAX ``serving_forward`` with the same weights: max abs
  error <= 0.2% of the output range per image (the whole-forward bar);
- ``multi_view_unpack_batch`` against JAX: <= 1e-5 * max(1, max|ref|);
- ``load_params_yaml`` equal to the JAX package's;
- the runner's read-only attributes, the CLI, and an import of every
  module of the port leaving ``jax`` out of ``sys.modules``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from multi_view_stereonet_tpu.data import GTASfMMultiViewDataset, get_testing_transforms
from multi_view_stereonet_tpu.data.loader import collate
from multi_view_stereonet_tpu.eval.streaming import serving_forward as jax_serving_forward
from multi_view_stereonet_tpu.models import MultiViewStereoNetConfig as JaxConfig
from multi_view_stereonet_tpu.train.config import load_params_yaml as jax_load_params_yaml
from multi_view_stereonet_tpu.train.pipeline import (
    multi_view_unpack_batch as jax_unpack)
from multi_view_stereonet_tpu_torch.checkpoint import random_state_dict
from multi_view_stereonet_tpu_torch.eval.streaming import (
    MODEL_KEYS, WEIGHTS_FILE, StreamingRunner, main, serving_forward)
from multi_view_stereonet_tpu_torch.models import MultiViewStereoNetConfig
from multi_view_stereonet_tpu_torch.train import load_params_yaml, multi_view_unpack_batch

from tests.synthetic_data import make_gta_sfm_tree
from tests.test_torch_model import FORWARD_BAR, JAX_PARITY, weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS, COLS, D = 64, 80, 4


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("gta"))
    data_dir, split = make_gta_sfm_tree(root, num_sequences=1, frames=3, rows=ROWS,
                                        cols=COLS, comparisons=1)
    dataset = GTASfMMultiViewDataset(
        data_dir, split, transform=get_testing_transforms({"size": [ROWS, COLS]}),
        shuffle=False, decode_backend="pil")
    return root, data_dir, split, dataset


def test_serving_matches_jax_serving_forward(tree):
    _, _, _, dataset = tree
    model, params = weights(seed=21)
    runner = StreamingRunner(model, MultiViewStereoNetConfig(num_idepth_samples=D),
                             device="cpu")
    jax_fn = jax.jit(lambda batch: jax_serving_forward(
        params, batch, JaxConfig(num_idepth_samples=D, **JAX_PARITY)))

    served = list(runner.run(dataset, batch_size=1, workers=1))
    assert len(served) == len(dataset) == 2
    for i, (idepth, names) in enumerate(served):
        batch = collate([dataset[i]])
        assert names == batch["left_filenames"]
        ref = np.asarray(jax_fn({k: jnp.asarray(batch[k]) for k in MODEL_KEYS}))
        got = idepth.numpy()
        assert got.shape == ref.shape == (1, ROWS, COLS)
        assert np.isfinite(got).all()
        span = float(ref.max() - ref.min())
        assert span > 0 and np.abs(got - ref).max() <= FORWARD_BAR * span
        # serving_forward on the same tensors is what the runner served.
        tensors = {k: torch.from_numpy(batch[k]) for k in MODEL_KEYS}
        with torch.no_grad():
            again = serving_forward(model, tensors,
                                    MultiViewStereoNetConfig(num_idepth_samples=D))
        np.testing.assert_array_equal(again.numpy(), got)


def test_unpack_matches_jax():
    rng = np.random.default_rng(3)
    B, V = 2, 2
    batch = {
        "left_image": rng.uniform(-1, 1, size=(B, 33, 41, 3)).astype(np.float32),
        "right_images": rng.uniform(-1, 1, size=(B, V, 33, 41, 3)).astype(np.float32),
        "K": np.tile(np.diag([30.0, 30.0, 1.0, 1.0]).astype(np.float32), (B, 1, 1)),
        "T_right_in_left": np.tile(np.eye(4, dtype=np.float32), (B, V, 1, 1)),
        "left_depthmap_true": rng.uniform(0, 5, size=(B, 33, 41)).astype(np.float32),
        "right_depthmap_true": rng.uniform(0, 5, size=(B, V, 33, 41)).astype(np.float32),
    }
    batch["T_right_in_left"][..., :3, 3] = rng.normal(size=(B, V, 3))
    batch["left_depthmap_true"][0, :3] = 0.0  # no depth: idepth stays 0
    got = multi_view_unpack_batch({k: torch.from_numpy(v) for k, v in batch.items()})
    ref = jax_unpack({k: jnp.asarray(v) for k, v in batch.items()})
    assert set(got) == set(ref)
    for key in ref:
        g, r = got[key], ref[key]
        for gi, ri in zip(g if isinstance(g, list) else [g], r if isinstance(r, list) else [r]):
            ri = np.asarray(ri)
            assert tuple(gi.shape) == ri.shape, key
            np.testing.assert_allclose(gi.numpy(), ri, rtol=0,
                                       atol=1e-5 * max(1.0, float(np.abs(ri).max())),
                                       err_msg=key)


def test_params_yaml_matches_jax(tmp_path):
    path = tmp_path / "params.yaml"
    path.write_text(yaml.safe_dump({"num_idepth_samples": 9, "refiners": [False] * 5}))
    assert load_params_yaml(str(path)) == jax_load_params_yaml(str(path))
    assert load_params_yaml(None) == jax_load_params_yaml(None)
    missing = str(tmp_path / "none.yaml")
    assert load_params_yaml(missing) == jax_load_params_yaml(missing)


def test_runner_attributes_are_read_only():
    model, _ = weights(seed=0)
    runner = StreamingRunner(model, MultiViewStereoNetConfig(), device="cpu")
    for name in ("model", "model_config", "device", "impl"):
        with pytest.raises(AttributeError):
            setattr(runner, name, None)
    assert runner.impl == "auto" and runner.device == torch.device("cpu")


def test_serving_forward_rejects_uint8_images():
    """The uint8 transport is not ported: u8 pixels must not be served as floats."""
    model, _ = weights(seed=0)
    batch = {"left_image": torch.zeros(1, ROWS, COLS, 3, dtype=torch.uint8),
             "right_images": torch.zeros(1, 1, ROWS, COLS, 3, dtype=torch.uint8),
             "K": torch.eye(4)[None], "T_right_in_left": torch.eye(4)[None, None]}
    with pytest.raises(TypeError, match="uint8 transport"):
        serving_forward(model, batch, MultiViewStereoNetConfig(num_idepth_samples=D))


def test_streaming_cli_serves_the_split(tree, tmp_path, capsys):
    _, data_dir, split, _ = tree
    run_dir = tmp_path / "run"
    weights_dir = run_dir / "checkpoints" / "epoch0000"
    weights_dir.mkdir(parents=True)
    (run_dir / "params.yaml").write_text(yaml.safe_dump(
        {"size": [ROWS, COLS], "num_idepth_samples": D}))
    torch.save(random_state_dict(4), str(weights_dir / WEIGHTS_FILE))
    main([str(weights_dir), data_dir, split, "--batch_size", "2", "--workers", "1",
          "--decode_backend", "pil", "--device", "cpu"])
    assert "2 depthmaps in" in capsys.readouterr().out


def test_port_imports_no_jax():
    """Every module of the port imports without pulling JAX in."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import multi_view_stereonet_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert 'jax' not in sys.modules, [m for m in sys.modules if m.startswith('jax')]\n"
        "print(len(names))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert int(proc.stdout.split()[-1]) >= 20

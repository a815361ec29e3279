"""The port's serving path on the CPU against the JAX package, and its import surface.

- ``serving_forward`` / ``StreamingRunner`` over a synthetic GTA-SfM tree at
  64x80 against the JAX ``serving_forward`` with the same weights: max abs
  error <= 0.2% of the output range per image (the whole-forward bar);
- ``multi_view_unpack_batch`` against JAX: <= 1e-5 * max(1, max|ref|);
- ``load_params_yaml`` equal to the JAX package's;
- the runner's read-only attributes, the CLI, and an import of every
  module of the port leaving ``jax`` and the JAX package out of
  ``sys.modules``.

The port's side reads the tree through the port's own datasets; the JAX
side through the JAX package's.
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

from multi_view_stereonet_tpu import data as jax_data
from multi_view_stereonet_tpu.data.loader import collate as jax_collate
from multi_view_stereonet_tpu.eval.streaming import serving_forward as jax_serving_forward
from multi_view_stereonet_tpu.models import MultiViewStereoNetConfig as JaxConfig
from multi_view_stereonet_tpu.train.config import load_params_yaml as jax_load_params_yaml
from multi_view_stereonet_tpu.train.pipeline import (
    multi_view_unpack_batch as jax_unpack)
from multi_view_stereonet_tpu_torch import data
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
    datasets = [m.GTASfMMultiViewDataset(
        data_dir, split, transform=m.get_testing_transforms({"size": [ROWS, COLS]}),
        shuffle=False, decode_backend="pil") for m in (data, jax_data)]
    return root, data_dir, split, datasets


def test_serving_matches_jax_serving_forward(tree):
    _, _, _, (dataset, jax_dataset) = tree
    model, params = weights(seed=21)
    runner = StreamingRunner(model, MultiViewStereoNetConfig(num_idepth_samples=D),
                             device="cpu")
    jax_fn = jax.jit(lambda batch: jax_serving_forward(
        params, batch, JaxConfig(num_idepth_samples=D, **JAX_PARITY)))

    served = list(runner.run(dataset, batch_size=1, workers=1))
    assert len(served) == len(dataset) == len(jax_dataset) == 2
    for i, (idepth, names) in enumerate(served):
        batch = jax_collate([jax_dataset[i]])
        assert names == batch["left_filenames"]
        ref = np.asarray(jax_fn({k: jnp.asarray(batch[k]) for k in MODEL_KEYS}))
        got = idepth
        assert type(got) is np.ndarray and got.shape == ref.shape == (1, ROWS, COLS)
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
    """uint8 pixels must not be served as floats: they are dequantized on the device
    (the u8 transport) and serve what their float32 images serve; an image type that is
    neither is refused."""
    model, _ = weights(seed=0)
    config = MultiViewStereoNetConfig(num_idepth_samples=D)
    rng = np.random.default_rng(1)
    left = rng.integers(0, 256, size=(1, ROWS, COLS, 3), dtype=np.uint8)
    rights = rng.integers(0, 256, size=(1, 1, ROWS, COLS, 3), dtype=np.uint8)
    T = np.eye(4, dtype=np.float32)[None, None].copy()
    T[..., 0, 3] = 0.4
    K = np.diag([0.9 * COLS, 0.9 * COLS, 1.0, 1.0]).astype(np.float32)[None]
    K[0, 0, 2], K[0, 1, 2] = (COLS - 1) / 2, (ROWS - 1) / 2

    def run(left, rights):
        batch = {"left_image": torch.from_numpy(left), "right_images": torch.from_numpy(rights),
                 "K": torch.from_numpy(K), "T_right_in_left": torch.from_numpy(T)}
        with torch.no_grad():
            return serving_forward(model, batch, config).numpy()

    def normalized(u):
        return (u.astype(np.float32) / 255.0) * 2.0 - 1.0

    got = run(left, rights)
    np.testing.assert_array_equal(got, run(normalized(left), normalized(rights)))
    assert not np.array_equal(got, run(left.astype(np.float32), rights.astype(np.float32)))
    with pytest.raises(TypeError, match="float32 or uint8"):
        run(normalized(left).astype(np.float64), normalized(rights))


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
    """Every module of the port imports without pulling in JAX or any module of the
    JAX package (``multi_view_stereonet_tpu`` or ``multi_view_stereonet_tpu.*``)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import multi_view_stereonet_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert 'jax' not in sys.modules, [m for m in sys.modules if m.startswith('jax')]\n"
        "ref = [m for m in sys.modules if m == 'multi_view_stereonet_tpu'\n"
        "       or m.startswith('multi_view_stereonet_tpu.')]\n"
        "assert not ref, ref\n"
        "print(len(names))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert int(proc.stdout.split()[-1]) >= 30

"""The port's eval CLI and what it writes with, against the JAX package, on the CPU.

- ``eval/test_cli.py`` ``run_eval`` against the JAX ``run_eval`` over synthetic
  64x80 trees (D = 4) with the same seeded fan-in-scale weights, written as
  the JAX package's msgpack and as the port's ``stereo_network.pth``: GTA-SfM
  at V = 1 (three samples at batch 2, so a trailing partial batch, with
  ``--save_images``), at V = 2, and DeMoN with its per-type files. The JAX
  side reads ``matmul_precision: highest`` from params.yaml. Bars: the same
  files, headers and filenames in the same order; loss columns and abs_rel,
  sq_rel, rmse and rmse_log within 1e-4 relative; a1-a3 within 1e-3
  absolute; NaN equal to NaN; every ``num_samples`` equal; runtime_ms present
  and not compared. The weights are seed 3's: at seeds 0-2 the refiners' ReLU
  leaves pixels with idepth near 0, whose depth 1/idepth magnifies f32
  rounding past 1e-4 in sq_rel; at seed 3 no pixel is near 0.
- The pieces: the metrics (exact: numpy on both sides), the supervised losses
  (1e-6 relative; ``compute_losses`` on one forward's outputs 1e-5, and each
  two-view branch on the two forwards of a rendered pair 1e-5, occlusion masks
  equal up to ties), the loss logs (identical text), the idepth images and the
  occlusion-mask images (identical bytes), timing.
"""

import dataclasses
import functools
import os
import random

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from multi_view_stereonet_tpu.checkpoint import convert_reference_state_dict
from multi_view_stereonet_tpu.checkpoint.native import save_params
from multi_view_stereonet_tpu.eval import metrics as jax_metrics
from multi_view_stereonet_tpu.eval.test_cli import run_eval as jax_run_eval
from multi_view_stereonet_tpu.losses import LossConfig as JaxLossConfig
from multi_view_stereonet_tpu.losses import compute_losses as jax_compute_losses
from multi_view_stereonet_tpu.losses import supervised as jax_supervised
from multi_view_stereonet_tpu.train import logging as jax_logging
from multi_view_stereonet_tpu.utils import visualization as jax_visualization
from multi_view_stereonet_tpu.utils.timing import count_parameters as jax_count_parameters
from multi_view_stereonet_tpu_torch.checkpoint import random_state_dict
from multi_view_stereonet_tpu_torch.eval import metrics
from multi_view_stereonet_tpu_torch.eval import test_cli
from multi_view_stereonet_tpu_torch.eval.streaming import WEIGHTS_FILE
from multi_view_stereonet_tpu_torch.losses import (
    LossConfig, compute_losses, masked_mean, pseudo_huber_loss, supervised_idepthmap_loss)
from multi_view_stereonet_tpu_torch.models import MultiViewStereoNetConfig
from multi_view_stereonet_tpu_torch.train import logging
from multi_view_stereonet_tpu_torch.utils import timing, visualization

from tests.synthetic_data import make_demon_tree, make_gta_sfm_tree
from tests.test_torch_cuda import rendered_pair
from tests.test_torch_losses import assert_masks_equal_but_ties
from tests.test_torch_model import nhwc_inputs, port_model_forward, weights

ROWS, COLS, D = 64, 80, 4
WEIGHTS_SEED = 3
REL_BAR = 1e-4       # loss columns and abs_rel, sq_rel, rmse, rmse_log
DELTA_BAR = 1e-3     # a1-a3, absolute
RATIOS = ("a1", "a2", "a3")
CASES = {
    # name: (tree, comparisons, batch_size, save_images)
    "gta_v1_partial_batch_images": ("gta", 1, 2, True),
    "gta_v2": ("gta", 2, 1, False),
    "demon": ("demon", 1, 1, False),
}


def write_weights(root, seed=WEIGHTS_SEED):
    """<root>/run/{params.yaml, checkpoints/epoch0000/} with one seed's weights in both
    formats; returns the weights dir."""
    run_dir = os.path.join(root, "run")
    weights_dir = os.path.join(run_dir, "checkpoints", "epoch0000")
    os.makedirs(weights_dir)
    with open(os.path.join(run_dir, "params.yaml"), "w") as f:
        yaml.safe_dump({"size": [ROWS, COLS], "num_idepth_samples": D,
                        "matmul_precision": "highest"}, f)
    sd = random_state_dict(seed)
    torch.save(sd, os.path.join(weights_dir, WEIGHTS_FILE))
    save_params(weights_dir, convert_reference_state_dict({k: v.numpy() for k, v in sd.items()}))
    return weights_dir


@functools.lru_cache(maxsize=None)
def jax_case(name, root):
    """The JAX CLI's run of one case, once per module: (weights dir, data dir, split,
    output dir)."""
    tree, comparisons, batch_size, save_images = CASES[name]
    root = os.path.join(root, name)
    if tree == "gta":
        data_dir, split = make_gta_sfm_tree(os.path.join(root, "gta"), num_sequences=1,
                                            frames=3 + comparisons, rows=ROWS, cols=COLS,
                                            comparisons=comparisons)
    else:
        data_dir, split = make_demon_tree(os.path.join(root, "demon"), num_scenes=1,
                                          frames=3, rows=ROWS, cols=COLS, plane_depth=4.0)
    weights_dir = write_weights(root)
    out = os.path.join(root, "jax_out")
    jax_run_eval(weights_dir, data_dir, split, out, batch_size=batch_size,
                 save_images=save_images, decode_backend="pil")
    return weights_dir, data_dir, split, out


@pytest.fixture(scope="module")
def case_root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("eval"))


def all_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def read_table(path):
    """(header, filenames, values (rows, cols)) of a metrics file."""
    with open(path) as f:
        lines = f.read().splitlines()
    header = lines[0].split()
    values = np.array([[float(x) for x in line.split()[1:]] for line in lines[1:]])
    return header, [line.split()[0] for line in lines[1:]], values.reshape(-1, len(header) - 1)


def read_kv(path):
    with open(path) as f:
        return {k: float(v) for k, v in (line.split(": ") for line in f.read().splitlines())}


def assert_values_close(keys, got, ref, what):
    for j, key in enumerate(keys):
        if key in RATIOS:
            np.testing.assert_allclose(got[..., j], ref[..., j], rtol=0, atol=DELTA_BAR,
                                       equal_nan=True, err_msg=f"{what} {key}")
        elif key != "runtime_ms":
            np.testing.assert_allclose(got[..., j], ref[..., j], rtol=REL_BAR, atol=0,
                                       equal_nan=True, err_msg=f"{what} {key}")


def assert_outputs_match(port_out, jax_out):
    files = all_files(port_out)
    assert files == all_files(jax_out)
    for name in files:
        if not name.endswith(".txt"):
            continue
        port_path, jax_path = os.path.join(port_out, name), os.path.join(jax_out, name)
        if name.startswith("avg_"):
            got, ref = read_kv(port_path), read_kv(jax_path)
            assert list(got) == list(ref), name
            assert got["num_samples"] == ref["num_samples"], name
            keys = list(ref)
            assert_values_close(keys, np.array([got[k] for k in keys]),
                                np.array([ref[k] for k in keys]), name)
            continue
        header, names, got = read_table(port_path)
        ref_header, ref_names, ref = read_table(jax_path)
        assert header == ref_header and names == ref_names, name
        assert got.shape == ref.shape, name
        if name == "runtime_metrics.txt":
            assert np.isfinite(got).all() and (got > 0).all()
        else:
            assert_values_close(header[1:], got, ref, name)


@pytest.mark.parametrize("name", list(CASES))
def test_eval_cli_matches_jax_run_eval(name, case_root):
    weights_dir, data_dir, split, jax_out = jax_case(name, case_root)
    _, _, batch_size, save_images = CASES[name]
    port_out = os.path.join(case_root, name, "port_out")
    loss, avg = test_cli.run_eval(weights_dir, data_dir, split, port_out,
                                  batch_size=batch_size, save_images=save_images,
                                  decode_backend="pil", device="cpu")
    assert np.isfinite(loss)
    assert_outputs_match(port_out, jax_out)
    expected = {"gta": 3, "demon": 6}[CASES[name][0]]
    assert avg["num_samples"] == expected
    if name == "demon":
        assert {"depth_metrics_rgbd.txt", "avg_depth_metrics_mvs.txt",
                "avg_depth_metrics_sun3d.txt"} <= set(os.listdir(port_out))
    if save_images:
        assert sum(f.endswith(".jpg") for f in all_files(port_out)) == 2 * expected


def test_eval_cli_main_writes_the_files(case_root, monkeypatch, capsys):
    """``main(argv)`` with ``--device cpu`` over the GTA V = 2 case's tree."""
    weights_dir, data_dir, split, jax_out = jax_case("gta_v2", case_root)
    monkeypatch.chdir(case_root)
    test_cli.main([weights_dir, data_dir, split, "--output_dir", "main_out",
                   "--decode_backend", "pil", "--device", "cpu"])
    assert "avg depth metrics:" in capsys.readouterr().out
    assert_outputs_match(os.path.join(case_root, "main_out"), jax_out)


def test_run_eval_needs_the_port_weights(tmp_path):
    """A directory without any weights file the port reads (stereo_network.pth,
    .msgpack or .pt) raises, naming the three, and no output is written."""
    with pytest.raises(FileNotFoundError,
                       match=f"{WEIGHTS_FILE}.*stereo_network.msgpack.*stereo_network.pt"):
        test_cli.run_eval(str(tmp_path), str(tmp_path), "gta_sfm_test.txt",
                          str(tmp_path / "out"), device="cpu")
    assert not (tmp_path / "out").exists()


def test_run_eval_runs_on_the_card_by_default(case_root, tmp_path):
    """With no device run_eval loads the model onto the card; without one, it raises
    rather than evaluating on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: run_eval would run on it")
    weights_dir, data_dir, split, _ = jax_case("gta_v2", case_root)
    with pytest.raises(RuntimeError, match="CUDA"):
        test_cli.run_eval(weights_dir, data_dir, split, str(tmp_path / "out"))


def test_run_eval_refuses_an_existing_output_dir(tmp_path):
    with pytest.raises(FileExistsError):
        test_cli.run_eval(str(tmp_path), str(tmp_path), "gta_sfm_test.txt", str(tmp_path),
                          device="cpu")


@pytest.mark.parametrize("split,limits", [("gta_sfm_test.txt", (0.0, 1e3)),
                                          ("demon_test.txt", (0.5, 10.0))])
def test_depth_limits(split, limits):
    assert test_cli.depth_limits(split) == limits


def test_depth_metrics_equal_jax():
    rng = np.random.default_rng(0)
    true = rng.uniform(0.5, 10, size=500).astype(np.float32)
    est = (true * rng.uniform(0.7, 1.4, size=500)).astype(np.float32)
    assert (metrics.get_depth_prediction_metrics(true, est)
            == jax_metrics.get_depth_prediction_metrics(true, est))


def test_compute_avg_metrics_equal_jax(tmp_path):
    path = tmp_path / "m.txt"
    rng = np.random.default_rng(1)
    rows = ["file abs_rel a1"] + [f"img{i}.jpg {rng.uniform()} {rng.uniform()}"
                                  for i in range(5)] + ["img5.jpg nan 0.5"]
    path.write_text("\n".join(rows) + "\n")
    got, ref = metrics.compute_avg_metrics(str(path)), jax_metrics.compute_avg_metrics(str(path))
    assert list(got) == list(ref) and got["num_samples"] == ref["num_samples"] == 6
    np.testing.assert_array_equal(np.array(list(got.values())), np.array(list(ref.values())))


def assert_rel(got, ref, bar):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=bar, atol=0)


@pytest.mark.parametrize("empty", [False, True])
def test_masked_mean_and_pseudo_huber_match_jax(empty):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 8, 10)).astype(np.float32)
    y = rng.normal(size=(2, 8, 10)).astype(np.float32)
    mask = np.zeros((2, 8, 10), bool) if empty else rng.uniform(size=(2, 8, 10)) > 0.4
    got = masked_mean(torch.from_numpy(x), torch.from_numpy(mask))
    assert_rel(got, jax_supervised.masked_mean(jnp.asarray(x), jnp.asarray(mask)), 1e-6)
    if empty:
        assert float(got) == 0.0
    for m in (None, mask):
        got = pseudo_huber_loss(torch.from_numpy(x), torch.from_numpy(y),
                                mask=None if m is None else torch.from_numpy(m))
        ref = jax_supervised.pseudo_huber_loss(jnp.asarray(x), jnp.asarray(y),
                                               mask=None if m is None else jnp.asarray(m))
        assert_rel(got, ref, 1e-6)


@pytest.mark.parametrize("size", [(64, 80), (32, 40), (16, 20), (8, 10), (4, 5)])
def test_supervised_idepthmap_loss_matches_jax(size):
    """Every pyramid size against a 64x80 truth, one image of three with no valid
    truth (it adds 0), with and without normalization."""
    rng = np.random.default_rng(sum(size))
    pred = rng.uniform(0.05, 0.5, size=(3,) + size).astype(np.float32)
    truth = rng.uniform(0.05, 0.5, size=(3, ROWS, COLS)).astype(np.float32)
    truth[truth < 0.1] = 0.0
    truth[1] = 0.0
    for normalize in (True, False):
        got = supervised_idepthmap_loss(torch.from_numpy(pred), torch.from_numpy(truth),
                                        torch.from_numpy(truth > 0), 100.0, normalize)
        ref = jax_supervised.supervised_idepthmap_loss(
            jnp.asarray(pred), jnp.asarray(truth), jnp.asarray(truth > 0), 100.0, normalize)
        assert np.isfinite(float(got))
        assert_rel(got, ref, 1e-6)


def test_compute_losses_matches_jax_on_a_forward():
    """The supervised branch on one forward's outputs (the port's, given to both)."""
    model, _ = weights(seed=WEIGHTS_SEED)
    left, rights, K, T = nhwc_inputs(1, 1, seed=0)
    out = port_model_forward(model, left, rights, K, T,
                             MultiViewStereoNetConfig(num_idepth_samples=D))
    truth = np.random.default_rng(4).uniform(0.05, 0.5, size=(1, ROWS, COLS))
    truth = truth.astype(np.float32)
    keys = ("left_idepthmap_pyr", "left_idepthmap_raw_pyr")
    loss, loss_dict, _ = compute_losses(
        {"left_idepthmap_true": torch.from_numpy(truth)},
        {k: [torch.from_numpy(x) for x in out[k]] for k in keys}, LossConfig())
    ref_loss, ref_dict, _ = jax_compute_losses(
        {"left_idepthmap_true": jnp.asarray(truth)},
        {k: [jnp.asarray(x) for x in out[k]] for k in keys}, JaxLossConfig())
    assert set(loss_dict) == set(ref_dict) == {"supervised_losses", "supervised_loss"}
    assert len(loss_dict["supervised_losses"]) == len(ref_dict["supervised_losses"]) == 6
    for got, ref in zip([loss, loss_dict["supervised_loss"]] + loss_dict["supervised_losses"],
                        [ref_loss, ref_dict["supervised_loss"]] + ref_dict["supervised_losses"]):
        assert_rel(got, ref, 1e-5)


@functools.lru_cache(maxsize=1)
def two_view_forwards():
    """(unpacked inputs, outputs) of the port's two-view forwards (the left one and the
    one with the images swapped) on a rendered tilted-plane pair, B = 2, numpy."""
    from multi_view_stereonet_tpu_torch.models import mvsnet_forward
    from multi_view_stereonet_tpu_torch.train.pipeline import unpack_batch

    model, _ = weights(seed=WEIGHTS_SEED)
    config = MultiViewStereoNetConfig(num_idepth_samples=D)
    batch = rendered_pair(2)
    with torch.no_grad():
        inputs = unpack_batch({k: torch.from_numpy(v) for k, v in batch.items()})
        outputs = {}
        for side, other, T in (("left", "right", "T_right_in_left"),
                               ("right", "left", "T_left_in_right")):
            out = mvsnet_forward(model, inputs[f"{side}_image_pyr"], inputs["K_pyr"],
                                 inputs[T][:, None],
                                 [p[:, None] for p in inputs[f"{other}_image_pyr"]], config)
            for kind in ("", "_raw"):
                outputs[f"{side}_idepthmap{kind}_pyr"] = out[f"left_idepthmap{kind}_pyr"]
    numpy = lambda tree: {k: [x.numpy() for x in v] if isinstance(v, list) else v.numpy()
                          for k, v in tree.items()}
    return numpy(inputs), numpy(outputs)


@pytest.mark.parametrize("config", [
    LossConfig(reconstruction_factor=0.5),
    LossConfig(left_right_factor=0.5),
    LossConfig(),
], ids=["reconstruction", "left_right", "two_view"])
def test_compute_losses_branch_matches_jax_on_two_forwards(config):
    """One branch of the two-view recipe on the port's two forwards (given to both): the
    loss, every entry of the loss dict (1e-5 relative) and every prediction (occlusion
    masks equal up to ties, predicted images within 1e-5 of their range)."""
    inputs, outputs = two_view_forwards()
    jax_config = JaxLossConfig(**dataclasses.asdict(config))
    tree = lambda d, f: {k: [f(x) for x in v] if isinstance(v, list) else f(v)
                         for k, v in d.items()}
    loss, loss_dict, preds = compute_losses(tree(inputs, torch.from_numpy),
                                            tree(outputs, torch.from_numpy), config)
    ref_loss, ref_dict, ref_preds = jax.jit(lambda i, o: jax_compute_losses(i, o, jax_config))(
        tree(inputs, jnp.asarray), tree(outputs, jnp.asarray))
    assert_rel(loss, ref_loss, 1e-5)
    assert set(loss_dict) == set(ref_dict)
    for k, v in ref_dict.items():
        for got, ref in zip(loss_dict[k] if isinstance(v, list) else [loss_dict[k]],
                            v if isinstance(v, list) else [v]):
            assert_rel(got, ref, 1e-5)
    if config.left_right_factor:
        assert float(ref_dict["left_right_loss"]) > 0  # masks with support
    assert set(preds) == set(ref_preds)
    for k, v in ref_preds.items():
        for lvl, (got, ref) in enumerate(zip(preds[k] if isinstance(v, list) else [preds[k]],
                                             v if isinstance(v, list) else [v])):
            if "image" in k:
                np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=2e-5)
                continue
            side, other = ("left", "right") if k.startswith("left") else ("right", "left")
            T = inputs["T_right_in_left" if side == "left" else "T_left_in_right"]
            if k.endswith("_true"):
                maps = [inputs[f"{s}_idepthmap_true"] for s in (side, other)]
            else:
                maps = [outputs[f"{s}_idepthmap_pyr"][lvl] for s in (side, other)]
            assert_masks_equal_but_ties(got, ref, jnp.asarray(inputs["K_pyr"][lvl]),
                                        jnp.asarray(T), *map(jnp.asarray, maps),
                                        f"{k}[{lvl}]")


def test_loss_logs_equal_jax(tmp_path):
    loss_dict = {"supervised_loss": np.float32(1.25),
                 "supervised_losses": [np.float32(0.5), np.float32(2.0)]}
    assert logging._flatten(loss_dict) == jax_logging._flatten(loss_dict)
    for module, name in ((logging, "port"), (jax_logging, "jax")):
        for step in range(2):
            module.log_losses(0, step, step, np.float32(1.5), loss_dict,
                              str(tmp_path / f"{name}_losses.txt"))
            module.log_validation_metrics(step, 0.75, {"abs_rel": 0.1, "a1": 0.9},
                                          str(tmp_path / f"{name}_validation.txt"))
    for kind in ("losses", "validation"):
        assert ((tmp_path / f"port_{kind}.txt").read_text()
                == (tmp_path / f"jax_{kind}.txt").read_text())


def test_idepth_images_equal_jax(tmp_path):
    rng = np.random.default_rng(5)
    est = rng.uniform(0, 0.5, size=(ROWS, COLS)).astype(np.float32)
    true = rng.uniform(0, 0.5, size=(ROWS, COLS)).astype(np.float32)
    visualization.save_idepth_images(str(tmp_path / "port"), 7, est, true)
    jax_visualization.save_idepth_images(str(tmp_path / "jax"), 7, est, true)
    for tag in ("est", "true"):
        name = f"idepthmap_7_{tag}.jpg"
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    np.testing.assert_array_equal(visualization.apply_cmap(est), jax_visualization.apply_cmap(est))
    np.testing.assert_array_equal(visualization._MAGMA_STOPS, jax_visualization._MAGMA_STOPS)
    normals = rng.uniform(-1, 1, size=(4, 5, 3))
    np.testing.assert_array_equal(visualization.apply_normal_map(normals),
                                  jax_visualization.apply_normal_map(normals))
    pyramid = [rng.uniform(size=(16 >> i, 20 >> i, 3)).astype(np.float32) for i in range(3)]
    np.testing.assert_array_equal(visualization.pyramid_collage(pyramid),
                                  jax_visualization.pyramid_collage(pyramid))


@pytest.mark.parametrize("truth", [True, False])
def test_occlusion_mask_images_equal_jax(truth, tmp_path):
    """The same mask and truth, the port's as tensors with a unit batch axis, the JAX
    function's as arrays: the same file names and bytes."""
    rng = np.random.default_rng(9)
    mask = rng.uniform(size=(ROWS, COLS)) < 0.3
    true = (rng.uniform(size=(ROWS, COLS)) < 0.3) if truth else None
    logging.log_debug_occlusion_mask(
        3, 7, 1234, torch.from_numpy(mask)[None],
        None if true is None else torch.from_numpy(true)[None], str(tmp_path / "port"))
    jax_logging.log_debug_occlusion_mask(3, 7, 1234, mask, true, str(tmp_path / "jax"))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == ["1234_0003.jpg"] + (["1234_true.jpg"] if truth else [])
    assert sorted(os.listdir(tmp_path / "port")) == names
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def test_timing_helpers(tmp_path):
    gen = timing.set_seeds(11)
    first = (random.random(), np.random.rand(), torch.rand(3, generator=gen))
    gen = timing.set_seeds(11)
    assert (random.random(), np.random.rand()) == first[:2]
    assert torch.equal(torch.rand(3, generator=gen), first[2])
    with timing.device_timer("cpu") as t:
        sum(range(1000))
    assert t.ms >= 0
    model, params = weights(seed=0)
    assert timing.count_parameters(model) == jax_count_parameters(params)
    with timing.profile_trace(None):
        pass
    with timing.profile_trace(str(tmp_path / "trace")):
        torch.ones(4).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0

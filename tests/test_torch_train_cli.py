"""The port's training CLI on the CPU, on small synthetic trees (32x48, D = 4, B = 2).

- Two steps, an epoch checkpoint (``state.pth`` and ``stereo_network.pth``), then a
  resume from it that continues the step count; losses.txt and validation.txt;
  the checkpoint scored by the port's ``run_eval``; plots and debug images.
- A real SIGTERM mid-epoch through ``GracefulStop``: the step ends, a checkpoint is
  written and a relaunch resumes from it.
- A NaN batch: the "-nanabort" dump of the last state whose loss was checked finite,
  never taken for an epoch checkpoint, and exit code 3.
- The DeMoN tree; the multi-process flags reaching ``parallel.initialize``, a bad
  process_id refused, and a one-process run that joins no group.
- Against the JAX ``train()``: the same tree, sgd, no augmentation, one loader
  worker, both runs started from one set of weights through
  ``previous_checkpoint_dir`` (msgpack for JAX, .pth for the port): losses.txt and
  validation.txt have the same header and rows, values within 1e-4 relative (the
  two-view recipe: ``tests/test_torch_two_view_cli.py``).
"""

import glob
import os
import signal

import numpy as np
import pytest
import torch
import yaml

from multi_view_stereonet_tpu.checkpoint import convert_reference_state_dict
from multi_view_stereonet_tpu.checkpoint.native import save_params as jax_save_params
from multi_view_stereonet_tpu.train.config import load_params_yaml as jax_load_params_yaml
from multi_view_stereonet_tpu.train.train_cli import train as jax_train
from multi_view_stereonet_tpu_torch.checkpoint import native, random_state_dict
from multi_view_stereonet_tpu_torch.eval.test_cli import run_eval
from multi_view_stereonet_tpu_torch.train import train_cli
from multi_view_stereonet_tpu_torch.train.config import load_params_yaml

from tests.synthetic_data import make_demon_tree, make_gta_sfm_tree

ROWS, COLS = 32, 48
REL_BAR = 1e-4


def tiny_cfg(**overrides):
    cfg = load_params_yaml(None)
    cfg.update({"size": [ROWS, COLS], "num_idepth_samples": 4, "batch_size": 2,
                "num_epochs": 1, "augment": False, "num_workers": 1,
                "debug_image_freq": 0, "plot_freq": 0, "decode_backend": "pil"})
    cfg.update(overrides)
    return cfg


@pytest.fixture(scope="module")
def gta(tmp_path_factory):
    root = tmp_path_factory.mktemp("gta")
    return make_gta_sfm_tree(str(root), rows=ROWS, cols=COLS, frames=6, num_sequences=1)


def read_rows(path):
    with open(path) as f:
        lines = [line.split() for line in f if line.strip()]
    return lines[0], lines[1:]


def test_train_checkpoints_resumes_and_its_checkpoint_evaluates(gta, tmp_path, capsys):
    data_dir, split = gta
    out = str(tmp_path / "run")
    cfg = tiny_cfg(augment=True, debug_image_freq=1, plot_freq=2)
    model = train_cli.train(cfg, data_dir, split, split, out, max_steps=2, device="cpu")
    assert isinstance(model, torch.nn.Module)
    root = os.path.join(out, "checkpoints")
    assert native.latest_epoch(root) == 0
    state = native.load_train_state(root, 0)
    assert state["step"] == 2 and state["optimizer"]["updates"] == 2
    for k, v in model.state_dict().items():
        torch.testing.assert_close(state["model"][k], v, rtol=0, atol=0)
    torch.testing.assert_close(native.load_params(os.path.join(root, "epoch0000")),
                               state["model"], rtol=0, atol=0)
    assert "resumed" not in capsys.readouterr().out

    # Plots of each losses.txt column and debug images of every level.
    assert os.path.exists(os.path.join(out, "plots", "supervised_loss.jpg"))
    assert os.path.exists(os.path.join(out, "plots", "index.html"))
    for lvl in range(5):
        assert glob.glob(os.path.join(out, "debug_images", f"left_idepthmap{lvl}", "*_0000.jpg"))

    train_cli.train(dict(cfg, num_epochs=2), data_dir, split, split, out, max_steps=3,
                    device="cpu")
    assert "resumed from epoch 0 (step 2)" in capsys.readouterr().out
    header, rows = read_rows(os.path.join(out, "losses.txt"))
    assert header[:5] == ["epoch", "batch", "step", "loss", "supervised_loss"]
    assert [r[:3] for r in rows] == [["0", "0", "1"], ["0", "1", "2"], ["1", "0", "3"]]
    assert all(np.isfinite(float(r[3])) for r in rows)
    header, rows = read_rows(os.path.join(out, "validation.txt"))
    assert header == ["epoch", "loss", "d1_all", "epe", "outlier_rate1", "outlier_rate2",
                      "outlier_rate3", "refined_zero_frac"]
    assert [r[0] for r in rows] == ["0", "1"]
    assert native.load_train_state(root, 1)["step"] == 3

    params_file = tmp_path / "params.yaml"
    params_file.write_text(yaml.safe_dump({"size": [ROWS, COLS], "num_idepth_samples": 4}))
    loss, avg = run_eval(os.path.join(root, "epoch0001"), data_dir, split,
                         str(tmp_path / "eval"), params_file=str(params_file),
                         decode_backend="pil", device="cpu")
    assert np.isfinite(loss) and avg["num_samples"] == 5


def test_sigterm_checkpoints_and_a_relaunch_resumes(gta, tmp_path, monkeypatch):
    data_dir, split = gta
    out = str(tmp_path / "run")

    class SignalingLoader(train_cli.BatchLoader):
        """Sends this process a real SIGTERM as the training loader hands out its first
        batch: the loop takes that step, then stops."""

        def __iter__(self):
            for i, batch in enumerate(super().__iter__()):
                if self.shuffle and i == 0:
                    os.kill(os.getpid(), signal.SIGTERM)
                yield batch

    previous = signal.getsignal(signal.SIGTERM)
    monkeypatch.setattr(train_cli, "BatchLoader", SignalingLoader)
    train_cli.train(tiny_cfg(), data_dir, split, split, out, device="cpu")
    assert signal.getsignal(signal.SIGTERM) == previous
    root = os.path.join(out, "checkpoints")
    assert native.latest_epoch(root) == 0 and native.load_train_state(root, 0)["step"] == 1
    assert not os.path.exists(os.path.join(out, "validation.txt"))  # stopped: no validation

    monkeypatch.setattr(train_cli, "BatchLoader", SignalingLoader.__mro__[1])
    train_cli.train(tiny_cfg(num_epochs=2), data_dir, split, "", out, max_steps=2,
                    device="cpu")
    assert native.latest_epoch(root) == 1 and native.load_train_state(root, 1)["step"] == 2


def test_graceful_stop_flags_sigterm_and_restores_the_handler():
    previous = signal.getsignal(signal.SIGTERM)
    stop = train_cli.GracefulStop()
    try:
        assert not stop()
        os.kill(os.getpid(), signal.SIGTERM)
        assert stop()
    finally:
        stop.restore()
    assert signal.getsignal(signal.SIGTERM) == previous


def test_nan_batch_dumps_the_last_finite_state_and_exits_3(gta, tmp_path, monkeypatch):
    data_dir, split = gta
    out = str(tmp_path / "run")

    class PoisonedLoader(train_cli.BatchLoader):
        """The first batch clean, every later one NaN."""

        def __iter__(self):
            for i, batch in enumerate(super().__iter__()):
                if i >= 1:
                    batch = dict(batch, left_image=np.full_like(batch["left_image"], np.nan))
                yield batch

    monkeypatch.setattr(train_cli, "BatchLoader", PoisonedLoader)
    with pytest.raises(SystemExit) as exc:
        train_cli.train(tiny_cfg(), data_dir, split, "", out, max_steps=4, device="cpu")
    assert exc.value.code == 3
    tagged = glob.glob(os.path.join(out, "checkpoints", "epoch*-nanabort"))
    assert len(tagged) == 1
    assert native.latest_epoch(os.path.join(out, "checkpoints")) is None
    state = torch.load(os.path.join(tagged[0], native.STATE_FILE), weights_only=True)
    # The state that produced the first (finite) loss: the initial weights, step 0.
    assert state["step"] == 0
    for v in native.load_params(tagged[0]).values():
        assert torch.isfinite(v).all()


def test_demon_tree_trains_and_validates(tmp_path):
    data_dir, split = make_demon_tree(str(tmp_path / "demon"), num_scenes=2, frames=3,
                                      rows=ROWS, cols=COLS)
    out = str(tmp_path / "run")
    train_cli.train(tiny_cfg(split="demon"), data_dir, split, split, out, max_steps=2,
                    device="cpu")
    header, rows = read_rows(os.path.join(out, "validation.txt"))
    assert "refined_zero_frac" in header
    assert np.isfinite(float(rows[0][header.index("loss")]))


def test_main_refuses_multi_process_flags_and_trains_on_the_cpu(gta, tmp_path, monkeypatch):
    """The multi-process flags reach ``parallel.initialize``; a process_id outside the
    group is refused (exit 2). With one process named the run is a single process: it
    joins no process group, launches no collective, and trains on the CPU."""
    data_dir, split = gta
    config = tmp_path / "params.yaml"
    config.write_text(yaml.safe_dump(tiny_cfg()))
    args = ["--config", str(config), "--data_dir", data_dir, "--train_split", split,
            "--output_dir", str(tmp_path / "run"), "--max_steps", "1", "--device", "cpu"]
    flags = ["--coordinator", "localhost:1234", "--num_processes"]
    with pytest.raises(SystemExit) as exc:
        train_cli.main(args + flags + ["2", "--process_id", "2"])
    assert exc.value.code == 2

    calls, initialize = [], train_cli.initialize

    def recording_initialize(*a, **kw):
        joined = initialize(*a, **kw)
        calls.append((a, kw, joined))
        return joined

    def no_collective(*a, **kw):
        raise AssertionError("a single process launched a collective")

    monkeypatch.setattr(train_cli, "initialize", recording_initialize)
    monkeypatch.setattr(torch.distributed, "all_reduce", no_collective)
    train_cli.main(args + flags + ["1", "--process_id", "0"])
    assert calls == [(("localhost:1234", 1, 0), {"device": "cpu"}, False)]
    assert not torch.distributed.is_initialized()
    assert native.latest_epoch(str(tmp_path / "run" / "checkpoints")) == 0


def compare_with_the_jax_cli(gta, tmp_path, val=True, **overrides):
    """Both CLIs over the tree from one set of weights: losses.txt (and validation.txt)
    with the same header and rows, values within REL_BAR."""
    data_dir, split = gta
    weights_dir = str(tmp_path / "weights")
    os.makedirs(weights_dir)
    sd = random_state_dict(3)
    torch.save(sd, os.path.join(weights_dir, native.PARAMS_FILE))
    jax_save_params(weights_dir, convert_reference_state_dict(
        {k: v.numpy() for k, v in sd.items()}))
    settings = {"size": [ROWS, COLS], "num_idepth_samples": 4, "batch_size": 2,
                "num_epochs": 1, "augment": False, "num_workers": 1, "optimizer": "sgd",
                "learning_rate": 1e-3, "debug_image_freq": 0, "plot_freq": 0,
                "decode_backend": "pil", "previous_checkpoint_dir": weights_dir,
                "matmul_precision": "highest", **overrides}
    jax_cfg = jax_load_params_yaml(None)
    jax_cfg.update(settings)
    val_split = split if val else ""
    jax_train(jax_cfg, data_dir, split, val_split, str(tmp_path / "jax"), max_steps=2)
    train_cli.train(tiny_cfg(**settings), data_dir, split, val_split, str(tmp_path / "port"),
                    max_steps=2, device="cpu")
    names = ("losses.txt", "validation.txt") if val else ("losses.txt",)
    assert os.path.exists(tmp_path / "port" / "validation.txt") == val
    for name in names:
        header, rows = read_rows(str(tmp_path / "port" / name))
        ref_header, ref_rows = read_rows(str(tmp_path / "jax" / name))
        assert header == ref_header and len(rows) == len(ref_rows) > 0
        lead = 3 if name == "losses.txt" else 1  # epoch, batch, step / epoch
        for row, ref in zip(rows, ref_rows):
            assert row[:lead] == ref[:lead]
            np.testing.assert_allclose(np.array(row[lead:], float), np.array(ref[lead:], float),
                                       rtol=REL_BAR, err_msg=name)
    return read_rows(str(tmp_path / "port" / "losses.txt"))[0]


def test_losses_and_validation_match_the_jax_cli(gta, tmp_path):
    compare_with_the_jax_cli(gta, tmp_path)

"""The port's convergence run (``train/convergence.py``) against the JAX script's.

- The split and the config: ``scripts/run_convergence.py:80-102`` restated below, line
  by line, and the port's config compared key by key with the JAX package's
  ``load_params_yaml(None)`` under those overrides.
- The port's run on the CPU (epoch 0, a resume, epoch 1) against the JAX ``train()`` run
  over both epochs with the same overrides, on one small ``layered_track`` tree (32x48,
  D = 4, B = 2), both from one set of weights through ``previous_checkpoint_dir``
  (msgpack for JAX, .pth for the port): epoch 0's losses.txt and validation.txt rows
  within 1e-4 relative, epoch 1's within 1e-3 (adam's first updates carry the last bits
  of the gradients on). The JAX run does not stop: the port's resume is
  held to an uninterrupted run.
- The resume check and the summary on hand-made files.
"""

import os

import numpy as np
import pytest
import torch

from multi_view_stereonet_tpu.checkpoint import convert_reference_state_dict
from multi_view_stereonet_tpu.checkpoint.native import save_params as jax_save_params
from multi_view_stereonet_tpu.train.config import load_params_yaml as jax_load_params_yaml
from multi_view_stereonet_tpu.train.train_cli import train as jax_train
from multi_view_stereonet_tpu_torch.checkpoint import native, random_state_dict
from multi_view_stereonet_tpu_torch.train.convergence import (
    check_continued, convergence_config, hold_out, read_table, run_convergence, summarize,
    validation_curve)

from tests.synthetic_data import make_gta_sfm_tree

ROWS, COLS = 32, 48
EPOCH0_BAR, RESUMED_BAR = 1e-4, 1e-3
# Settings both runs take on top of the convergence config, for a small CPU run.
SMALL = {"num_idepth_samples": 4, "num_workers": 1, "decode_backend": "pil",
         "matmul_precision": "highest"}


def jax_script_config(size, batch, epochs_total, augment, transfer_u8):
    """``scripts/run_convergence.py:90-102``, restated."""
    cfg = jax_load_params_yaml(None)                    # :90
    cfg.update({                                        # :91
        "size": list(size),                             # :92
        "batch_size": batch,                            # :93
        "num_epochs": epochs_total,                     # :94
        "augment": augment,                             # :95
        "transfer_u8": transfer_u8,                     # :96
        "supervision_factor": 1.0,                      # :97
        "reconstruction_factor": 0.0,                   # :98
        "left_right_factor": 0.0,                       # :99
        "learning_rate": 1e-3,                          # :100
        "debug_image_freq": 10_000,                     # :101
        "plot_freq": 50,                                # :102
    })
    return cfg


def jax_script_split(lines):
    """``scripts/run_convergence.py:80-88``, restated: (train lines, held-out lines)."""
    lines = [line for line in lines if line.strip()]    # :80
    n_train = int(len(lines) * 0.8)                     # :81
    return lines[:n_train], lines[n_train:]             # :86, :88


@pytest.mark.parametrize("size, batch, epochs, augment, u8", [
    ((96, 128), 4, 200, False, False),   # Run A, the JAX script's defaults
    ((480, 640), 8, 150, True, True),    # Run B, the recipe shape
])
def test_config_equals_the_jax_scripts_key_by_key(size, batch, epochs, augment, u8):
    got = convergence_config(size, batch, epochs, augment, u8)
    want = jax_script_config(size, batch, epochs, augment, u8)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key] == want[key], key


@pytest.mark.parametrize("n_lines", [6, 18, 50])
def test_split_equals_the_jax_scripts(tmp_path, n_lines):
    split = tmp_path / "split.txt"
    lines = [f"test/seq00/color/{i:06d}.jpg test/seq00/color/{i + 1:06d}.jpg\n"
             for i in range(n_lines)]
    split.write_text("".join(lines) + "\n")
    train_split, val_split, n_train, n_val = hold_out(str(split), str(tmp_path))
    want_train, want_val = jax_script_split(lines)
    assert (n_train, n_val) == (len(want_train), len(want_val))
    assert os.path.basename(train_split) == "train_gta_sfm.txt"
    assert os.path.basename(val_split) == "val_gta_sfm.txt"
    assert open(train_split).readlines() == want_train
    assert open(val_split).readlines() == want_val


def test_run_across_a_resume_matches_the_jax_train(tmp_path, capsys):
    data_dir, split = make_gta_sfm_tree(str(tmp_path / "tree"), num_sequences=2, frames=4,
                                        rows=ROWS, cols=COLS, seed=7, scene="layered_track")
    weights_dir = str(tmp_path / "weights")
    os.makedirs(weights_dir)
    sd = random_state_dict(3)
    torch.save(sd, os.path.join(weights_dir, native.PARAMS_FILE))
    jax_save_params(weights_dir, convert_reference_state_dict(
        {k: v.numpy() for k, v in sd.items()}))

    work, dest = str(tmp_path / "port"), str(tmp_path / "dest")
    summary = run_convergence(data_dir, split, work, dest, size=(ROWS, COLS), batch=2,
                              epochs_first=1, epochs_total=2, tag="layered_track",
                              device="cpu", init_weights_dir=weights_dir, overrides=SMALL)
    out = capsys.readouterr().out
    assert f"resumed params from {weights_dir}" in out
    assert "resumed from epoch 0 (step 2)" in out
    assert (summary["n_train"], summary["n_val"]) == (4, 2)

    jax_cfg = jax_script_config((ROWS, COLS), 2, 2, False, False)
    jax_cfg.update(SMALL, previous_checkpoint_dir=weights_dir)
    train_split, val_split = (os.path.join(work, f) for f in ("train_gta_sfm.txt",
                                                               "val_gta_sfm.txt"))
    jax_train(jax_cfg, data_dir, train_split, val_split, str(tmp_path / "jax"), max_epochs=2)

    for name, lead in (("losses", 3), ("validation", 1)):
        header, rows = read_table(os.path.join(dest, f"{name}_layered_track.txt"))
        ref_header, ref_rows = read_table(str(tmp_path / "jax" / f"{name}.txt"))
        assert header == ref_header and len(rows) == len(ref_rows) == (4 if lead == 3 else 2)
        for row, ref in zip(rows, ref_rows):
            assert row[:lead] == ref[:lead]
            bar = EPOCH0_BAR if row[0] == "0" else RESUMED_BAR
            np.testing.assert_allclose(np.array(row[lead:], float), np.array(ref[lead:], float),
                                       rtol=bar, err_msg=f"{name} epoch {row[0]}")

    # The final epoch's weights, and a summary beside the rows it was made from.
    final = native.load_params(os.path.join(work, "run", "checkpoints", "epoch0001"))
    for k, v in native.load_params(os.path.join(dest, "layered_track")).items():
        torch.testing.assert_close(v, final[k], rtol=0, atol=0)
    text = open(os.path.join(dest, "SUMMARY_layered_track.md")).read()
    curve = validation_curve(os.path.join(dest, "validation_layered_track.txt"))
    assert f"| this run | final | 1 | {curve['loss'][1]:.4f} | {curve['epe'][1]:.4f} |" in text


def test_resume_check_refuses_a_gap_or_a_restart(tmp_path):
    losses, validation = tmp_path / "losses.txt", tmp_path / "validation.txt"
    validation.write_text("epoch loss epe refined_zero_frac \n0 2.0 9.0 1.0 \n1 1.5 8.0 0.0 \n")
    head = "epoch batch step loss \n"
    losses.write_text(head + "0 0 1 3.0 \n0 1 2 2.0 \n1 0 3 1.5 \n1 1 4 1.2 \n")
    check_continued(str(losses), str(validation), 2)
    for body in ("0 0 1 3.0 \n0 1 2 2.0 \n1 0 1 1.5 \n",    # the step count restarted
                 "0 0 1 3.0 \n0 1 2 2.0 \n1 1 3 1.5 \n",    # a batch skipped
                 "0 0 1 3.0 \n0 1 2 2.0 \n2 0 3 1.5 \n"):   # an epoch skipped
        losses.write_text(head + body)
        with pytest.raises(ValueError):
            check_continued(str(losses), str(validation), 2)
    losses.write_text(head + "0 0 1 3.0 \n")
    with pytest.raises(ValueError):
        check_continued(str(losses), str(validation), 3)  # validation.txt lacks epoch 2


def test_summary_takes_the_best_epe_and_the_epoch_refiners_stay_alive_from():
    curve = {"epoch": [0, 1, 2, 3], "loss": [5.0, 4.0, 3.0, 3.5], "epe": [9.0, 7.0, 6.0, 6.5],
             "refined_zero_frac": [0.99, 0.0, 0.1, 0.0]}
    summary = summarize(curve)
    assert (summary["best_epoch"], summary["best_epe"], summary["alive_from"]) == (2, 6.0, 3)
    assert summary["table"]["first"] == {"epoch": 0, "loss": 5.0, "epe": 9.0,
                                         "refined_zero_frac": 0.99}
    assert summary["table"]["final"]["epoch"] == 3
    curve["refined_zero_frac"][-1] = 0.5
    assert summarize(curve)["alive_from"] is None

"""The port's training CLI in the two-view recipe on the CPU, against the JAX ``train()``.

``estimate_right_idepthmap``: the loader's V-axis batch adapted to the two-view step,
on the small synthetic tree of ``tests/test_torch_train_cli.py`` (32x48, D = 4, B = 2),
both runs from one set of weights: losses.txt with the same header and rows, values
within 1e-4 relative, with every loss branch and no validation split (the JAX CLI's
validation cannot run those branches), and with supervision only and validation.
Both at an SGD rate of 1e-6: at 1e-3 and 1e-4 the first step of this 11-level loss
(~1000) kills the refiners' output ReLU on both sides, and the second step's raw level
carries the first step's ~1e-4 gradient rounding amplified to 1e-4 - 1e-3 relative.
Validation with a right-view loss is refused before anything runs.
"""

import pytest

from multi_view_stereonet_tpu_torch.train import train_cli

from tests.test_torch_train_cli import compare_with_the_jax_cli, gta, tiny_cfg  # noqa: F401


@pytest.mark.parametrize("factors,val", [
    (dict(reconstruction_factor=0.5, left_right_factor=0.5), False),
    (dict(reconstruction_factor=0.0, left_right_factor=0.0), True),
], ids=["every_loss", "supervised_with_validation"])
def test_two_view_recipe_matches_the_jax_cli(gta, tmp_path, factors, val):
    """estimate_right_idepthmap: the loader's V-axis batch adapted to the two-view step,
    with every loss branch and no validation split (the JAX CLI's validation cannot run
    those branches), and with supervision only and validation."""
    header = compare_with_the_jax_cli(gta, tmp_path, val, estimate_right_idepthmap=True,
                                      supervision_factor=1.0, learning_rate=1e-6, **factors)
    if factors["reconstruction_factor"]:
        assert {"reconstruction_loss", "left_right_loss", "reconstruction_losses0"} <= set(header)
    # 5 refined levels and the raw one of the left view, 5 of the right.
    assert "supervised_losses10" in header


@pytest.mark.parametrize("factor", ["reconstruction_factor", "left_right_factor"])
def test_validation_with_a_right_view_loss_is_refused_up_front(gta, tmp_path, factor):
    data_dir, split = gta
    out = tmp_path / "run"
    cfg = tiny_cfg(estimate_right_idepthmap=True, **{factor: 0.5})
    with pytest.raises(ValueError, match="right-view outputs"):
        train_cli.train(cfg, data_dir, split, split, str(out), max_steps=1, device="cpu")
    assert not (out / "losses.txt").exists()

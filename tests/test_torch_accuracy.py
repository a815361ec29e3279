"""The port's ladder (``eval/accuracy.py``, ``scripts/accuracy_speed_torch.py``) against
the JAX script's (``scripts/accuracy_speed.py``), and Run A's committed weights.

- ``CONFIGS`` equals the JAX dict; ``abs_rel_over_batches`` equals the JAX function on
  seeded maps; the script's canonical batches are bit-equal to ``canonical_batches``.
- "highest" on seeded weights (32x48, D = 4, the layered scene) within 1e-4 relative of
  the JAX forward's abs_rel; the configs at "highest"'s modes ("default",
  "refiners_f32", "warp_high") bit-equal to it, and a ladder whose maps differ there
  raises.
- Run A's weights (``docs/convergence_torch/layered_track``) on its regenerated held-out
  split, on the CPU's plain path: EPE and abs_rel within 1e-3 relative of the card's
  (``ladder.json``) and equal to ``ladder_cpu.json`` (what ``chip_smoke.py`` phase 15
  holds the card to); the same weights written as the reference's TorchScript archive
  (``tests/reference_archive.py``) and read by the JAX ``load_any_params``: the JAX
  forward's abs_rel within 1e-4 relative of the port's.
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_view_stereonet_tpu.checkpoint import convert_reference_state_dict
from multi_view_stereonet_tpu.checkpoint.native import load_any_params as jax_load_any_params
from multi_view_stereonet_tpu.models import MultiViewStereoNetConfig as JaxConfig
from multi_view_stereonet_tpu.models import mvsnet_forward as jax_mvsnet_forward
from multi_view_stereonet_tpu.train.pipeline import multi_view_unpack_batch as jax_unpack
from multi_view_stereonet_tpu_torch.checkpoint import load_any_params, random_state_dict
from multi_view_stereonet_tpu_torch.eval import accuracy
from multi_view_stereonet_tpu_torch.models import MultiViewStereoNet

from tests.reference_archive import write_reference_archive

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS, COLS, D = 32, 48, 4
JAX_BAR, CARD_BAR, CPU_BAR = 1e-4, 1e-3, 1e-5
RUN_A = os.path.join(REPO, "docs", "convergence_torch", "layered_track")


def script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts",
                                                                      f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


jax_script = script("accuracy_speed")
port_script = script("accuracy_speed_torch")


def model_from(sd):
    model = MultiViewStereoNet()
    model.load_state_dict(sd)
    return model.eval()


def jax_abs_rel(params, batches, num_idepth_samples):
    """The JAX script's "highest" forward (``accuracy_speed.py:142-147``) scored by its
    ``abs_rel_over_batches``."""
    config = JaxConfig(num_idepth_samples=num_idepth_samples, **jax_script.CONFIGS["highest"])

    @jax.jit
    def forward(jbatch):
        inputs = jax_unpack(jbatch)
        out = jax_mvsnet_forward(params, inputs["left_image_pyr"], inputs["K_pyr"],
                                 inputs["T_right_in_left"], inputs["right_image_pyr"], config)
        return out["left_idepthmap_pyr"][0] / inputs["baseline"][:, None, None]

    return jax_script.abs_rel_over_batches(
        lambda b: np.asarray(forward({k: jnp.asarray(v) for k, v in b.items()})), batches)


def test_configs_equal_the_jax_dict():
    assert accuracy.CONFIGS == jax_script.CONFIGS
    assert list(accuracy.CONFIGS) == list(jax_script.CONFIGS)


def test_abs_rel_equals_the_jax_function():
    rng = np.random.default_rng(0)
    batches = []
    for n in (2, 1):
        depth = rng.uniform(2.0, 40.0, (n, 8, 12)).astype(np.float32)
        depth[0, 0, :3] = [0.0, 1e3, 2e3]  # outside the GTA mask
        batches.append({"left_depthmap_true": depth})
    maps = [rng.uniform(-0.05, 0.6, (len(b["left_depthmap_true"]), 8, 12)).astype(np.float32)
            for b in batches]
    maps[0][1, 2, :4] = [0.0, 1e-4, -1.0, 2e-3]  # no estimate; estimates past the mask

    def fn(maps):
        it = iter(maps)
        return lambda b: next(it)
    assert accuracy.abs_rel_over_batches(fn(maps), batches) == \
        jax_script.abs_rel_over_batches(fn(maps), batches)


@pytest.mark.parametrize("scene, jax_scene, normal, comparisons", [
    ("plane", "plane", None, 1),
    ("slanted", "plane", (0.35, 0.25, 1.0), 1),
    ("layered", "layered", None, 2),
])
def test_canonical_batches_are_bit_equal_to_the_jax_scripts(tmp_path, scene, jax_scene,
                                                            normal, comparisons):
    got = port_script.canonical_batches(str(tmp_path), scene, ROWS, COLS, comparisons)
    want = jax_script.canonical_batches(scene=jax_scene, rows=ROWS, cols=COLS,
                                        comparisons=comparisons, plane_normal=normal)
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k


@pytest.fixture(scope="module")
def layered(tmp_path_factory):
    """The canonical layered batches at 32x48 and seeded fan-in-scale weights."""
    root = tmp_path_factory.mktemp("layered")
    return (port_script.canonical_batches(str(root), "layered", ROWS, COLS, 1),
            random_state_dict(0))


def test_highest_abs_rel_matches_the_jax_forward(layered):
    batches, sd = layered
    rows = accuracy.ladder(model_from(sd), batches, "cpu", ["highest"],
                           {"num_idepth_samples": D})
    params = convert_reference_state_dict({k: v.numpy() for k, v in sd.items()})
    want = jax_abs_rel(params, batches, D)
    assert np.isfinite(want) and want > 0
    np.testing.assert_allclose(rows["highest"]["abs_rel"], want, rtol=JAX_BAR)


def test_configs_at_highests_modes_are_bit_equal_and_a_difference_raises(layered,
                                                                         monkeypatch):
    batches, sd = layered
    model = model_from(sd)
    names = ["highest", "default", "refiners_f32", "warp_high", "bf16", "high"]
    rows = accuracy.ladder(model, batches, "cpu", names, {"num_idepth_samples": D})
    for name in ("default", "refiners_f32", "warp_high"):
        assert rows[name]["same_modes_as"] == "highest" and rows[name]["bit_equal"]
        assert rows[name]["abs_rel"] == rows["highest"]["abs_rel"]
        assert rows[name]["levels"] == [(0.0, 0.0)] * 5
    assert rows["bf16"]["same_modes_as"] is None and rows["bf16"]["class"] == "bf16"
    assert rows["high"]["same_modes_as"] is None and rows["high"]["class"] == "tf32"
    assert rows["highest"]["ms"] is None  # not measured off the card
    classes = {name: accuracy.mode_class(accuracy.model_config(name))
               for name in accuracy.CONFIGS}
    assert [n for n, c in classes.items() if c == "exact"] == [
        "highest", "default", "refiners_f32", "warp_high"]

    forward_maps = accuracy.forward_maps

    def perturbed(model, batch, config, device):
        levels, epe = forward_maps(model, batch, config, device)
        if config == accuracy.model_config("default", num_idepth_samples=D):
            levels[3] = np.nextafter(levels[3], np.inf)
        return levels, epe
    monkeypatch.setattr(accuracy, "forward_maps", perturbed)
    with pytest.raises(AssertionError, match="default resolves to highest"):
        accuracy.ladder(model, batches[:1], "cpu", ["highest", "default"],
                        {"num_idepth_samples": D})


@pytest.fixture(scope="module")
def run_a(tmp_path_factory):
    """Run A's held-out split regenerated from its seed, its committed weights, and the
    port's "highest" row on the CPU."""
    work = str(tmp_path_factory.mktemp("run_a"))
    batches = port_script.held_out_batches(work, "layered_track", (96, 128), 2, 10)
    sd = load_any_params(RUN_A)
    rows = accuracy.ladder(model_from(sd), batches, "cpu", ["highest"],
                           {"num_idepth_samples": 12})
    return batches, sd, rows["highest"]


def test_run_a_weights_give_the_card_figures_on_the_cpu(run_a):
    _, _, row = run_a
    with open(os.path.join(RUN_A, "ladder.json")) as f:
        card = json.load(f)
    assert "H100" in card["card"]
    with open(os.path.join(RUN_A, "ladder_cpu.json")) as f:
        cpu = json.load(f)
    for key in ("abs_rel", "epe"):
        np.testing.assert_allclose(row[key], card["rows"]["highest"][key], rtol=CARD_BAR)
        np.testing.assert_allclose(row[key], cpu["rows"]["highest"][key], rtol=CPU_BAR)


def test_run_a_weights_through_the_jax_reader(run_a, tmp_path):
    batches, sd, row = run_a
    assert sum(p.numel() for p in sd.values()) == 608614
    assert all(v.dtype == torch.float32 for v in sd.values())
    write_reference_archive(sd, str(tmp_path / "stereo_network.pt"))
    params = jax_load_any_params(str(tmp_path))
    np.testing.assert_allclose(jax_abs_rel(params, batches, 12), row["abs_rel"], rtol=JAX_BAR)

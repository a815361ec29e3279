"""The port's training at ``compute_dtype: bfloat16`` against the JAX package's, on the
CPU, 64x80, and the CLIs' dtype keys.

The port's ``make_loss_fn`` and ``loss.backward()`` at bf16 against
``jax.value_and_grad`` of the JAX ``make_loss_fn`` at
``MultiViewStereoNetConfig(compute_dtype="bfloat16", **JAX_PARITY)``, on the same
seeded numpy inputs and weights (``tests/test_torch_train.py``'s helpers). The
parameters, the loss and the gradients are f32 on both sides; the activations are
bf16.

Why no tight per-leaf bar against JAX's bf16 gradient: bf16 rounding is chaotic, and
the two sides round at different points. The port lies from the exact (f32) gradient
up to 7x as far as JAX at bf16 does on single leaves (``refiner4.res3.conv1.weight``:
0.077 against 0.011 of the leaf's max), and on others it is the more accurate of the
two. The conv biases that feed a GroupNorm, and ``conv_final.bias``, in refiners 0-1:
JAX's bf16 gradient lies 0.32-0.46 of the leaf's max from its f32 gradient (cosine
0.986), the port's 0.005-0.011 (cosine 1.0000). The port adds those biases in f32
(K4's ``xbias``, as XLA's CPU compiler computes the JAX layers' unrounded ``conv +
b``), while the JAX layer adds them at bf16 (``models/layers.py:57``) and so sums a
bf16 cotangent in the backward. So the port is held to the exact gradient at JAX's
own bf16 distance from it, not to JAX's bf16 noise. The exact gradient is JAX's f32
gradient for the multi-view recipe; for the two-view recipe it is the port's f32
gradient, which ``tests/test_torch_train.py::test_two_view_gradients_match_jax`` holds
to JAX's on the first pair below (measured 4.3e-7 flat relative L2; 4.2e-7 to 1.2e-5 on
the others), and which spares a ~30 s JAX compile. Bars, each with the value measured
on these inputs:

- the loss within 5e-3 relative of JAX's bf16 loss (measured 4.5e-4; two-view
  1.5e-3 to 1.8e-3);
- the flat gradient (every parameter concatenated) within 2x JAX's own bf16 relative
  L2 distance from the exact gradient (measured 1.28x; two-view 0.97x and 0.91x);
- the flat gradient within 0.06 relative L2 of JAX's bf16 gradient (measured 3.3e-2;
  two-view 3.1e-2 and 2.5e-2);
- every leaf above 1e-4 of the largest exact leaf at cosine >= 0.97 with it
  (measured >= 0.984; 0.975 on the flip pair below);
- discriminating: the port's bf16 gradient at least 1e-2 relative L2 from its f32
  gradient (measured 2.9e-2 to 6.5e-2; a run that silently stays at f32 reads ~6e-7).

The two-view recipe with every loss (a rendered tilted-plane pair, B=1, D=4) has a
level-4 map of 4x5 pixels. On the pair of ``tests/test_torch_train.py`` (seed 11, seed
20 weights) one of its 20 refined values (0.0018 at f32) lies inside the bf16 noise of
the refiner's output (up to 0.0077 elsewhere on that map) of the ReLU's kink: at bf16
the port's rounds to 0 there and JAX's does not. That pixel's gradient, about 1/20 of
``refiner4.conv_final.weight``'s, the largest leaf (48% of the gradient's squared
norm), and what flows from it into the extractor, give the port 2.08x JAX's distance
from the exact gradient and 0.064 from JAX's bf16 gradient; that pair is held at 2.5x
and 0.08, the loss (measured 1.8e-3), the cosine (0.975) and the discriminating bar
(6.5e-2) unchanged. Two more pairs (pair seeds 12 and 14, weight seeds 20 and 22) hold
the bars above; three other inputs (weight / pair seeds 20 / 13, 21 / 11, 23 / 15) read
0.84x-1.01x and 2.2e-2 to 2.6e-2.

Also: ``remat_refiners`` at bf16 equal to no remat at ``WIRING_BAR`` (measured:
bit-equal); ``train()`` at bf16 on a 32x48 tree (two steps, validation, a checkpoint,
a resume) with finite losses and f32 parameters; the train CLI's dtype keys; and the
repair of the CLIs' dtype keys: each reads those its JAX counterpart reads, no
others (the eval CLI ``compute_dtype``, the streaming CLI ``--bf16`` alone).
"""

import functools
import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from multi_view_stereonet_tpu.losses import LossConfig as JaxLossConfig
from multi_view_stereonet_tpu.models import MultiViewStereoNetConfig as JaxConfig
from multi_view_stereonet_tpu.train import step as jax_step
from multi_view_stereonet_tpu_torch.checkpoint import (
    native, random_state_dict, state_dict_from_jax_params)
from multi_view_stereonet_tpu_torch.eval import streaming, test_cli
from multi_view_stereonet_tpu_torch.losses import LossConfig
from multi_view_stereonet_tpu_torch.models import MultiViewStereoNetConfig, resolve_dtypes
from multi_view_stereonet_tpu_torch.train import step, train_cli

from tests.synthetic_data import make_gta_sfm_tree
from tests.test_torch_cuda import rendered_pair
from tests.test_torch_model import JAX_PARITY, weights
from tests.test_torch_train import (
    FLOOR, TWO_VIEW_FACTORS, WIRING_BAR, make_batch, port_loss_and_grads, tensors)
from tests.test_torch_train_cli import read_rows, tiny_cfg

BF16 = torch.bfloat16
LOSS_BAR = 5e-3            # relative to JAX's bf16 loss; measured <= 1.8e-3
EXACT_RATIO = 2.0          # times JAX's bf16 distance from the exact gradient; <= 1.28x
JAX_BF16_BAR = 0.06        # relative L2 from JAX's bf16 gradient; measured <= 3.3e-2
LEAF_COS = 0.97            # with the exact gradient, leaves above FLOOR; >= 0.975
SILENT_F32_BAR = 1e-2      # the port's bf16 from its f32 gradient; >= 2.9e-2 (f32: ~6e-7)
# The two-view pair of tests/test_torch_train.py: one level-4 ReLU flip within the bf16
# noise (module docstring).
TWO_VIEW_EXACT_RATIO, TWO_VIEW_JAX_BF16_BAR = 2.5, 0.08  # measured 2.08x and 0.064
D = 4
TWO_VIEW = dict(multi_view=False, estimate_right_idepthmap=True)


@functools.lru_cache(maxsize=None)
def jax_value_and_grad(dtype, D, two_view):
    """The jitted ``value_and_grad`` of the JAX ``make_loss_fn``, built once a
    configuration: inputs of the same shapes reuse its compile."""
    loss_fn = jax_step.make_loss_fn(
        JaxConfig(num_idepth_samples=D, compute_dtype=dtype, **JAX_PARITY),
        JaxLossConfig(**(TWO_VIEW_FACTORS if two_view else {})),
        **(TWO_VIEW if two_view else {}))
    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def jax_grads(params, batch, dtype, D, two_view=False):
    """(loss, {port parameter name: gradient}) of the JAX ``make_loss_fn`` at ``dtype``."""
    (loss, _), grads = jax_value_and_grad(dtype, D, two_view)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    grads = state_dict_from_jax_params(jax.tree.map(np.asarray, grads))
    return float(loss), {k: v.numpy() for k, v in grads.items()}


def port_grads(model, batch, dtype, D, two_view=False):
    """(loss, gradients) of the port's ``make_loss_fn`` at ``dtype``; the gradients
    must come back f32, as the parameters are."""
    loss_fn = step.make_loss_fn(
        MultiViewStereoNetConfig(num_idepth_samples=D, compute_dtype=dtype),
        LossConfig(**(TWO_VIEW_FACTORS if two_view else {})),
        **(TWO_VIEW if two_view else {}))
    model.zero_grad(set_to_none=True)
    loss, _ = loss_fn(model, tensors(batch))
    assert loss.dtype == torch.float32
    loss.backward()
    assert all(p.dtype == p.grad.dtype == torch.float32 for p in model.parameters())
    return loss.item(), {k: p.grad.numpy().copy() for k, p in model.named_parameters()}


def flat(grads):
    return np.concatenate([grads[k].ravel() for k in sorted(grads)]).astype(np.float64)


def distance(got, ref):
    """The relative L2 distance of the flat gradients."""
    return float(np.linalg.norm(flat(got) - flat(ref)) / np.linalg.norm(flat(ref)))


def check_bf16(port, jax16, exact, port32, exact_ratio=EXACT_RATIO,
               jax_bf16_bar=JAX_BF16_BAR):
    """The module docstring's bars on (loss, gradients) pairs."""
    (loss, got), (loss16, ref16), (_, exact), (_, got32) = port, jax16, exact, port32
    assert np.isfinite(loss)
    assert abs(loss - loss16) <= LOSS_BAR * abs(loss16), (loss, loss16)
    own, jax_own = distance(got, exact), distance(ref16, exact)
    assert own <= exact_ratio * jax_own, (own, jax_own)
    assert distance(got, ref16) <= jax_bf16_bar, distance(got, ref16)
    floor = FLOOR * max(float(np.abs(v).max()) for v in exact.values())
    for k, r in exact.items():
        if float(np.abs(r).max()) > floor:
            cos = float(np.vdot(got[k], r) / (np.linalg.norm(got[k]) * np.linalg.norm(r)))
            assert cos >= LEAF_COS, (k, cos)
    assert distance(got, got32) >= SILENT_F32_BAR, distance(got, got32)


@pytest.mark.parametrize("B,V,D,seed", [(2, 2, 4, 20)])
def test_bf16_gradients_match_jax(B, V, D, seed):
    """The multi-view recipe; V = 1 and D = 9 at bf16 run in
    tests/test_torch_model_fuzz.py's forward sweep."""
    model, params = weights(seed)
    batch = make_batch(B, V, seed)
    check_bf16(port_grads(model, batch, "bfloat16", D),
               jax_grads(params, batch, "bfloat16", D),
               jax_grads(params, batch, "float32", D),
               port_grads(model, batch, "float32", D))


def check_two_view(weights_seed, pair_seed, *bars):
    """Every loss branch (supervision 1.0, left-right and reconstruction 0.5), the right
    view's forward included, on a rendered pair; the exact gradient is the port's f32."""
    model, params = weights(weights_seed)
    batch = rendered_pair(1, pair_seed)
    port32 = port_grads(model, batch, "float32", D, two_view=True)
    check_bf16(port_grads(model, batch, "bfloat16", D, two_view=True),
               jax_grads(params, batch, "bfloat16", D, two_view=True), port32, port32,
               *bars)


def test_two_view_bf16_gradients_match_jax():
    """tests/test_torch_train.py's pair, with its ReLU flip (module docstring)."""
    check_two_view(20, 11, TWO_VIEW_EXACT_RATIO, TWO_VIEW_JAX_BF16_BAR)


@pytest.mark.parametrize("weights_seed,pair_seed", [(20, 12), (22, 14)])
def test_two_view_bf16_gradients_hold_the_multi_view_bars(weights_seed, pair_seed):
    """Two more pairs at the multi-view recipe's bars (measured 0.97x and 0.91x, 3.1e-2
    and 2.5e-2)."""
    check_two_view(weights_seed, pair_seed)


def test_remat_refiners_at_bf16_gives_the_same_gradients():
    model, _ = weights(20)
    batch = make_batch(2, 2, 20)
    loss, ref = port_loss_and_grads(model, batch, MultiViewStereoNetConfig(
        num_idepth_samples=4, compute_dtype="bfloat16"))
    loss_remat, got = port_loss_and_grads(model, batch, MultiViewStereoNetConfig(
        num_idepth_samples=4, compute_dtype="bfloat16", remat_refiners=True))
    assert np.isfinite(loss) and abs(loss_remat - loss) <= WIRING_BAR * abs(loss)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=0,
                                   atol=WIRING_BAR * float(np.abs(ref[k]).max()), err_msg=k)


# ---- the CLIs ----


@pytest.fixture(scope="module")
def gta(tmp_path_factory):
    root = tmp_path_factory.mktemp("gta")
    return make_gta_sfm_tree(str(root), rows=32, cols=48, frames=6, num_sequences=1)


def test_train_cli_trains_at_bf16_checkpoints_and_resumes(gta, tmp_path, monkeypatch, capsys):
    """Two steps with validation and an epoch checkpoint, then a resume for one: the
    forward runs at bf16 (every config the loop builds resolves to bf16), the losses
    are finite, and the parameters and the checkpoint stay f32."""
    data_dir, split = gta
    out = str(tmp_path / "run")
    seen = []
    forward = train_cli.mvsnet_forward

    def spy(model, *args):
        seen.append(resolve_dtypes(args[4]))
        return forward(model, *args)
    monkeypatch.setattr(train_cli, "mvsnet_forward", spy)
    monkeypatch.setattr(step, "mvsnet_forward", spy)
    cfg = tiny_cfg(compute_dtype="bfloat16", augment=True)
    model = train_cli.train(cfg, data_dir, split, split, out, max_steps=2, device="cpu")
    assert all(p.dtype == torch.float32 for p in model.parameters())
    train_cli.train(dict(cfg, num_epochs=2), data_dir, split, split, out, max_steps=3,
                    device="cpu")
    assert "resumed from epoch 0 (step 2)" in capsys.readouterr().out
    assert len(seen) >= 5 and set(seen) == {(BF16,) * 3}  # 3 steps, validation
    _, rows = read_rows(os.path.join(out, "losses.txt"))
    assert [r[:3] for r in rows] == [["0", "0", "1"], ["0", "1", "2"], ["1", "0", "3"]]
    assert all(np.isfinite(float(x)) for r in rows for x in r[3:])
    _, val = read_rows(os.path.join(out, "validation.txt"))
    assert [r[0] for r in val] == ["0", "1"] and all(np.isfinite(float(x)) for x in val[1][1:])
    state = native.load_train_state(os.path.join(out, "checkpoints"), 1)
    assert state["step"] == 3
    assert all(v.dtype == torch.float32 for v in state["model"].values())
    assert all(torch.isfinite(v).all() for v in state["model"].values())


@pytest.fixture
def run_tree(gta, tmp_path):
    """(weights dir, data dir, split, params.yaml path) with seeded weights; the
    params.yaml sets refiner_dtype and frontend_dtype bfloat16 and no compute_dtype."""
    data_dir, split = gta
    run_dir = tmp_path / "run"
    weights_dir = run_dir / "checkpoints" / "epoch0000"
    weights_dir.mkdir(parents=True)
    params = run_dir / "params.yaml"
    params.write_text(yaml.safe_dump({"size": [32, 48], "num_idepth_samples": 4,
                                      "refiner_dtype": "bfloat16",
                                      "frontend_dtype": "bfloat16"}))
    torch.save(random_state_dict(3), weights_dir / streaming.WEIGHTS_FILE)
    return str(weights_dir), data_dir, split, str(params)


def test_eval_cli_reads_compute_dtype_only(run_tree, tmp_path, monkeypatch):
    """refiner_dtype / frontend_dtype: bfloat16 in params.yaml leave the eval CLI's
    forward at f32, as the JAX eval CLI's (which reads compute_dtype alone)."""
    weights_dir, data_dir, split, _ = run_tree
    seen = []
    forward = test_cli.mvsnet_forward

    def spy(model, *args):
        seen.append(resolve_dtypes(args[4]))
        return forward(model, *args)
    monkeypatch.setattr(test_cli, "mvsnet_forward", spy)
    loss, _ = test_cli.run_eval(weights_dir, data_dir, split, str(tmp_path / "out"),
                                device="cpu")
    assert np.isfinite(loss) and seen and set(seen) == {(torch.float32,) * 3}


def test_streaming_cli_takes_its_dtype_from_bf16_alone(run_tree, monkeypatch):
    """compute_dtype: bfloat16 in params.yaml without --bf16 serves at f32, as the JAX
    streaming CLI does; --bf16 serves at bf16 whatever params.yaml says."""
    weights_dir, data_dir, split, params = run_tree
    with open(params) as f:
        cfg = yaml.safe_load(f)
    bf16_params = os.path.join(os.path.dirname(params), "params_bf16.yaml")
    with open(bf16_params, "w") as f:
        yaml.safe_dump({**cfg, "compute_dtype": "bfloat16"}, f)
    configs = []

    class Runner:
        def __init__(self, model, model_config, **kwargs):
            configs.append(model_config)

        def run(self, dataset, batch_size, workers):
            return iter(())
    monkeypatch.setattr(streaming, "StreamingRunner", Runner)
    for path, flags in ((bf16_params, []), (params, []), (params, ["--bf16"])):
        streaming.main([weights_dir, data_dir, split, "--params_yaml", path, "--device",
                        "cpu", *flags])
    assert [resolve_dtypes(c) for c in configs] == [(torch.float32,) * 3] * 2 + [(BF16,) * 3]

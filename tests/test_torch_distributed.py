"""The port's multi-process training on the CPU: two processes over gloo, 64x80, D = 4
(``tests/_torch_distributed_worker.py`` is each process), against the JAX package's
single-process step on the global batch.

- ``ShardedDataset`` and ``local_shard_indices`` against the JAX package's, with and
  without ``drop_ragged_tail``, over several sample and process counts.
- ``make_train_step`` with a mesh, global B = 4 at V = 2: data parallel (2 samples a
  process), ``mesh_view`` 2 (data 1, one view a process), and the 2 x 2 ``(data, view)``
  grid of four processes (the data groups strided, ranks {0, 2} and {1, 3}; every
  gradient through both all-reduces); and the two-view recipe with every loss (factors
  1.0 / 0.5 / 0.5), global B = 2. Against ``jax.value_and_grad``
  of the JAX ``make_loss_fn`` on the global batch, with the weights carried across by
  ``state_dict_from_jax_params``, at ``tests/test_torch_train.py``'s bars
  (docs/PARITY.md:218-232): the loss identical on both processes and within 1e-5
  relative of JAX's, every gradient within the bar. Sample 0's truth is 60% invalid,
  the others' 5%, so the processes hold very different valid counts: the mean of the
  two per-process losses, which plain data parallelism would give, misses JAX's by
  more than the bar.
- Data parallel and ``mesh_view`` 2 at ``compute_dtype: bfloat16``: the two processes'
  loss and gradients against one process's bf16 step on the global batch (the port's;
  JAX's bf16 step is held to the port's in tests/test_torch_bf16_train.py): the loss
  within 1e-5 relative (measured: equal), the flat gradient within 1e-2 relative L2
  (measured 2.1e-3 and 2.3e-3), and the loss identical on both processes.
- The train CLI as two processes (``--coordinator``, sgd, no augmentation, one loader
  worker, global B = 4): process 0's losses.txt against the JAX train step on the
  per-process batches concatenated in process order, as the JAX package's
  ``global_batch`` does, for two steps and a third after a relaunch resumes; one
  checkpoint directory an epoch, which the single-process eval CLI scores.
- A NaN in one process's batch: both exit with code 3, process 0 alone dumps.
- One loader a view group: the train CLI as two processes at ``mesh_view`` 2 with
  augmentation and two loader threads (global B = 4 at V = 2, two steps), each step
  recorded (``record_training``): at every step both ranks train on process 0's loaded
  batch, the left image, K, the poses and the left truth equal and each rank's views
  its slice; process 1 decodes no sample; process 0's debug images come from the whole
  batch; the first step's loss and gradient within the bars above of the JAX
  ``make_loss_fn`` on the batch process 0 loaded.
- The refusals: a batch not divisible by the data size, views not divisible by
  ``mesh_view``, ``mesh_view`` without the processes, and with the two-view recipe.

Every worker has a time limit and the process group a finite timeout, so a deadlock
fails its test instead of hanging the run.
"""

import json
import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from multi_view_stereonet_tpu.losses import LossConfig as JaxLossConfig
from multi_view_stereonet_tpu.models import MultiViewStereoNetConfig as JaxConfig
from multi_view_stereonet_tpu.parallel import ShardedDataset as JaxShardedDataset
from multi_view_stereonet_tpu.parallel import local_shard_indices as jax_local_shard_indices
from multi_view_stereonet_tpu.train import step as jax_step
from multi_view_stereonet_tpu_torch.checkpoint import (
    init_params_numpy, native, state_dict_from_jax_params)
from multi_view_stereonet_tpu_torch.eval.test_cli import run_eval
from multi_view_stereonet_tpu_torch.models import MultiViewStereoNet, MultiViewStereoNetConfig
from multi_view_stereonet_tpu_torch.parallel import (
    ProcessMesh, ShardedDataset, local_shard_indices, make_process_mesh)
from multi_view_stereonet_tpu_torch.train import train_cli

from tests._torch_distributed_worker import digest, start, wait
from tests.synthetic_data import make_gta_sfm_tree
from tests.test_torch_cuda import rendered_pair
from tests.test_torch_model import JAX_PARITY, weights
from tests.test_torch_train import (
    LOSS_BAR, TWO_VIEW_FACTORS, assert_grads_close, jax_loss_and_grads, make_batch,
    port_loss_and_grads)
from tests.test_torch_train_cli import REL_BAR, read_rows, tiny_cfg

D = 4
BF16_GRAD_BAR = 1e-2  # flat relative L2, bf16 data parallel against one process
INVALID = (0.6, 0.05, 0.05, 0.05)  # the share of each sample's truth set to 0


def uneven(batch: dict, keys) -> dict:
    """The batch with INVALID[b] of sample b's truth depth set to 0."""
    rng = np.random.default_rng(7)
    batch = dict(batch)
    for k in keys:
        depth = batch[k].copy()
        depth[depth == 0] = 5.0
        for b in range(len(depth)):
            depth[b][rng.uniform(size=depth[b].shape) < INVALID[b]] = 0.0
        batch[k] = depth
    return batch


# ---- ShardedDataset ----


@pytest.mark.parametrize("drop", [True, False])
@pytest.mark.parametrize("count", [1, 2, 3, 4])
@pytest.mark.parametrize("n", [0, 7, 10])
def test_sharded_dataset_matches_jax(n, count, drop):
    samples = list(range(n))
    for i in range(count):
        got = ShardedDataset(samples, i, count, drop_ragged_tail=drop)
        ref = JaxShardedDataset(samples, i, count, drop_ragged_tail=drop)
        assert [got[j] for j in range(len(got))] == [ref[j] for j in range(len(ref))]
        assert local_shard_indices(n, i, count) == jax_local_shard_indices(n, i, count)
        if drop:  # the default, as in the JAX package
            default = ShardedDataset(samples, i, count)
            assert len(default) == len(got) == n // count


# ---- the train step against JAX's on the global batch ----


@pytest.fixture(scope="module")
def step_results(tmp_path_factory):
    """Both processes' results of each case, and the references, computed while the
    workers run: {case: ([rank 0, rank 1], (JAX loss, JAX loss dict, grads))}; the bf16
    cases' reference is one process's step at bf16, (loss, grads)."""
    tmp = str(tmp_path_factory.mktemp("steps"))
    model, params = weights(20)
    torch.save(model.state_dict(), os.path.join(tmp, "weights.pth"))
    batches = {
        "multi_view": uneven(make_batch(4, 2, 20), ["left_depthmap_true"]),
        "two_view": uneven(rendered_pair(2), ["left_depthmap_true", "right_depthmap_true"]),
    }
    for name, batch in batches.items():
        np.savez(os.path.join(tmp, f"{name}.npz"), **batch)

    def case(batch, mesh_view, two_view):
        return {"weights": os.path.join(tmp, "weights.pth"), "mesh_view": mesh_view,
                "batch": os.path.join(tmp, f"{batch}.npz"), "two_view": two_view, "D": D,
                "factors": TWO_VIEW_FACTORS if two_view else {}}
    cases = {"data": case("multi_view", 1, False), "view": case("multi_view", 2, False),
             "two_view": case("two_view", 1, True),
             "data_bf16": dict(case("multi_view", 1, False), dtype="bfloat16"),
             "view_bf16": dict(case("multi_view", 2, False), dtype="bfloat16")}
    procs = start({"mode": "step", "out": tmp, "cases": cases}, tmp, "steps")
    procs += start({"mode": "step", "out": tmp, "cases": {"grid": case("multi_view", 2, False)}},
                   tmp, "grid", n=4)
    try:
        ref_loss, ref_grads = jax_loss_and_grads(params, batches["multi_view"], D)
        loss_fn = jax_step.make_loss_fn(JaxConfig(num_idepth_samples=D, **JAX_PARITY),
                                        JaxLossConfig(**TWO_VIEW_FACTORS), multi_view=False,
                                        estimate_right_idepthmap=True)
        (loss, loss_dict), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            params, {k: jnp.asarray(v) for k, v in batches["two_view"].items()})
        two_view_ref = (float(loss), jax.tree.map(np.asarray, loss_dict),
                        {k: v.numpy() for k, v in state_dict_from_jax_params(
                            jax.tree.map(np.asarray, grads)).items()})
        bf16_ref = port_loss_and_grads(model, batches["multi_view"], MultiViewStereoNetConfig(
            num_idepth_samples=D, compute_dtype="bfloat16"))
    finally:
        results = wait(procs)
    for rc, out, err in results:
        assert rc == 0 and "RESULT ok" in out, err[-3000:]
    ranks = {name: [dict(np.load(os.path.join(tmp, f"{name}_rank{r}.npz"))) for r in (0, 1)]
             for name in cases}
    ranks["grid"] = [dict(np.load(os.path.join(tmp, f"grid_rank{r}.npz"))) for r in range(4)]
    multi_view_ref = (ref_loss, None, ref_grads)
    return {"data": (ranks["data"], multi_view_ref), "view": (ranks["view"], multi_view_ref),
            "grid": (ranks["grid"], multi_view_ref),
            "two_view": (ranks["two_view"], two_view_ref),
            **{name: (ranks[name], bf16_ref) for name in ("data_bf16", "view_bf16")}}


def check_step(ranks, ref, data_parallel):
    ref_loss, ref_dict, ref_grads = ref
    r0, r1 = ranks[:2]
    assert all(r["loss"] == r0["loss"] for r in ranks)  # every process: the global loss
    np.testing.assert_allclose(float(r0["loss"]), ref_loss, rtol=LOSS_BAR)
    grads = {k[len("grad/"):]: v for k, v in r0.items() if k.startswith("grad/")}
    for k, v in grads.items():
        for r in ranks[1:]:
            np.testing.assert_array_equal(v, r[f"grad/{k}"], err_msg=k)
    assert_grads_close(grads, ref_grads)
    for k, v in (ref_dict or {}).items():
        np.testing.assert_allclose(r0[f"dict/{k}"], np.asarray(v), rtol=LOSS_BAR, err_msg=k)
    if data_parallel:
        # What plain data parallelism would report: the mean of the per-process losses.
        averaged = (float(r0["local_loss"]) + float(r1["local_loss"])) / 2
        assert abs(averaged - ref_loss) > LOSS_BAR * abs(ref_loss), (averaged, ref_loss)


def test_data_parallel_step_matches_jax_on_the_global_batch(step_results):
    """Two processes of two samples each, V = 2, uneven valid counts."""
    check_step(*step_results["data"], data_parallel=True)


def test_view_sharded_step_matches_jax(step_results):
    """mesh_view 2, data 1: each process one of the two comparison views of all four
    samples; the level-4 means over V all-reduced within the forward."""
    check_step(*step_results["view"], data_parallel=False)


def test_data_view_grid_of_four_processes_matches_jax(step_results):
    """mesh_view 2 over four processes: data 2 x view 2, each process one view of two
    samples; the loss's masked means summed over the strided data groups, the level-4
    means over V within each view group, the gradients averaged over all four."""
    check_step(*step_results["grid"], data_parallel=False)


@pytest.mark.parametrize("case", ["data_bf16", "view_bf16"])
def test_step_at_bf16_matches_one_process(step_results, case):
    """Data parallel, and mesh_view 2, at compute_dtype bfloat16, against one
    process's step at bf16 on the global batch."""
    ranks, (loss, ref) = step_results[case]
    r0, r1 = ranks
    assert r0["loss"] == r1["loss"] and np.isfinite(loss)
    np.testing.assert_allclose(float(r0["loss"]), loss, rtol=LOSS_BAR)
    got = np.concatenate([r0[f"grad/{k}"].ravel() for k in sorted(ref)])
    want = np.concatenate([ref[k].ravel() for k in sorted(ref)])
    assert all(r0[f"grad/{k}"].dtype == np.float32 for k in ref)
    gap = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    assert gap <= BF16_GRAD_BAR, gap


def test_two_view_recipe_data_parallel_matches_jax(step_results):
    """The photometric, occlusion and left-right masked means over the global batch:
    every loss and the loss dict's entries, one sample a process."""
    check_step(*step_results["two_view"], data_parallel=True)


# ---- the train CLI as two processes ----


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Eight samples: four a process, two steps an epoch at a global batch of 4."""
    root = tmp_path_factory.mktemp("gta")
    return make_gta_sfm_tree(str(root), rows=32, cols=48, frames=9, num_sequences=1)


def cli_job(tree, tmp_path, out, **overrides):
    data_dir, split = tree
    cfg = tiny_cfg(batch_size=4, optimizer="sgd", learning_rate=1e-3, **overrides)
    config = tmp_path / "params.yaml"
    config.write_text(yaml.safe_dump(cfg))
    return cfg, ["--config", str(config), "--data_dir", data_dir, "--train_split", split,
                 "--output_dir", out]


def global_batches(cfg, tree, epoch):
    """The batches of ``epoch`` as the JAX package's ``global_batch`` assembles them:
    each process's loader batch (its strided shard), concatenated in process order."""
    data_dir, split = tree
    loaders = []
    for r in (0, 1):
        dataset = train_cli.make_dataset(cfg, data_dir, split, True, 0,
                                         np.random.default_rng(cfg["seed"]))
        loader = train_cli.BatchLoader(ShardedDataset(dataset, r, 2), cfg["batch_size"] // 2,
                                       shuffle=cfg["shuffle"], seed=cfg["seed"], workers=1)
        loader.set_epoch(epoch)
        loaders.append(loader)
    for parts in zip(*loaders):
        yield {k: jnp.asarray(np.concatenate([p[k] for p in parts]))
               for k in parts[0] if not k.endswith("filenames")}


def test_cli_as_two_processes_matches_jax_checkpoints_and_resumes(tree, tmp_path):
    out = str(tmp_path / "run")
    cfg, argv = cli_job(tree, tmp_path, out)
    first = wait(start({"mode": "cli", "argv": argv + ["--max_steps", "2"]}, str(tmp_path),
                       "first"))
    second = wait(start({"mode": "cli", "argv": argv + ["--max_steps", "3", "--max_epochs",
                                                         "2"]}, str(tmp_path), "second"))
    for rc, _, err in first + second:
        assert rc == 0, err[-3000:]
    assert "resumed from epoch 0 (step 2)" in second[0][1]
    assert "loss" not in second[1][1]  # process 1 logs nothing
    root = os.path.join(out, "checkpoints")
    assert sorted(os.listdir(root)) == ["epoch0000", "epoch0001"]
    state = native.load_train_state(root, 1)
    assert state["step"] == 3 and not any(k.startswith("module.") for k in state["model"])
    model = MultiViewStereoNet()
    model.load_state_dict(native.load_params(os.path.join(root, "epoch0001")))

    # The JAX step on the concatenated per-process batches, from the CLI's init.
    tx = jax_step.make_optimizer(jax_step.OptimizerConfig(
        optimizer="sgd", learning_rate=1e-3, steps_per_epoch=2))
    train_step = jax.jit(jax_step.make_train_step(
        JaxConfig(num_idepth_samples=D, **JAX_PARITY), JaxLossConfig(), tx))
    params = jax.tree.map(jnp.asarray, init_params_numpy(cfg["seed"], reference=True))
    opt_state = tx.init(params)
    ref = []
    for epoch, steps in ((0, 2), (1, 1)):
        for _, batch in zip(range(steps), global_batches(cfg, tree, epoch)):
            params, opt_state, loss, loss_dict = train_step(params, opt_state, batch)
            ref.append([float(loss)] + [float(x) for k in sorted(loss_dict)
                                        for x in np.atleast_1d(loss_dict[k])])
    header, rows = read_rows(os.path.join(out, "losses.txt"))
    assert [r[:3] for r in rows] == [["0", "0", "1"], ["0", "1", "2"], ["1", "0", "3"]]
    np.testing.assert_allclose(np.array([r[3:] for r in rows], float), np.array(ref),
                               rtol=REL_BAR)

    params_file = tmp_path / "eval_params.yaml"
    params_file.write_text(yaml.safe_dump({"size": cfg["size"], "num_idepth_samples": D}))
    loss, avg = run_eval(os.path.join(root, "epoch0001"), *tree, str(tmp_path / "eval"),
                         params_file=str(params_file), decode_backend="pil", device="cpu")
    assert np.isfinite(loss) and avg["num_samples"] == 8


def test_a_nan_in_one_process_ends_both_with_exit_3(tree, tmp_path):
    out = str(tmp_path / "run")
    _, argv = cli_job(tree, tmp_path, out)
    results = wait(start({"mode": "cli", "argv": argv + ["--max_steps", "4"],
                          "poison_rank": 1}, str(tmp_path), "nan"))
    assert [rc for rc, _, _ in results] == [3, 3], [err[-2000:] for _, _, err in results]
    assert "FATAL: non-finite loss" in results[0][2]
    assert "FATAL" not in results[1][2]
    root = os.path.join(out, "checkpoints")
    assert os.listdir(root) == ["epoch0000-nanabort"]
    # The state that produced the first (finite) loss: the initial weights, step 0.
    state = torch.load(os.path.join(root, "epoch0000-nanabort", native.STATE_FILE),
                       weights_only=True)
    assert state["step"] == 0


# ---- one loader a view group ----


@pytest.fixture(scope="module")
def view_group_run(tmp_path_factory):
    """(record dir, run dir, seed, each rank's rank<r>.json) of the train CLI as two
    processes at mesh_view 2, augmentation on, two loader threads, over eight samples
    at V = 2: two steps of a global batch of 4."""
    root = tmp_path_factory.mktemp("view_group")
    data_dir, split = make_gta_sfm_tree(str(root / "gta"), rows=32, cols=48, frames=10,
                                        num_sequences=1, comparisons=2)
    cfg = tiny_cfg(batch_size=4, mesh_view=2, augment=True, num_workers=2,
                   debug_image_freq=2)
    config = root / "params.yaml"
    config.write_text(yaml.safe_dump(cfg))
    out, record = str(root / "run"), str(root / "record")
    argv = ["--config", str(config), "--data_dir", data_dir, "--train_split", split,
            "--output_dir", out, "--max_steps", "2"]
    for rc, _, err in wait(start({"mode": "cli", "argv": argv, "record": record},
                                 str(root), "view_group")):
        assert rc == 0, err[-3000:]
    ranks = []
    for r in (0, 1):
        with open(os.path.join(record, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    return record, out, cfg["seed"], ranks


def test_a_view_group_trains_on_its_leaders_batch(view_group_run):
    record, out, _, ranks = view_group_run
    assert [len(r["digests"]) for r in ranks] == [2, 2]
    for k in range(2):
        assert not os.path.exists(os.path.join(record, f"loaded{k}_rank1.npz"))
        loaded = dict(np.load(os.path.join(record, f"loaded{k}_rank0.npz")))
        assert loaded["right_images"].shape[:2] == (4, 2)
        for r, rank in enumerate(ranks):
            share = ProcessMesh(view=2, view_index=r).shard_batch(loaded)
            assert rank["digests"][k] == {key: digest(v) for key, v in share.items()}, (k, r)
    assert ranks[0]["digests"][0] != ranks[0]["digests"][1]
    assert os.listdir(os.path.join(out, "debug_images"))


def test_only_the_view_groups_leader_decodes(view_group_run):
    _, _, _, ranks = view_group_run
    assert [r["decoded"] for r in ranks] == [8, 0]


def test_a_view_groups_first_step_matches_jax(view_group_run):
    """The loss and gradient the two processes applied at step 1, from the CLI's init,
    against JAX's on the batch process 0 loaded."""
    record, _, seed, _ = view_group_run
    batch = dict(np.load(os.path.join(record, "loaded0_rank0.npz")))
    step0 = torch.load(os.path.join(record, "step0.pt"), weights_only=True)
    params = jax.tree.map(jnp.asarray, init_params_numpy(seed, reference=True))
    ref_loss, ref_grads = jax_loss_and_grads(params, batch, D)
    np.testing.assert_allclose(step0["loss"], ref_loss, rtol=LOSS_BAR)
    assert_grads_close({k: v.numpy() for k, v in step0["grads"].items()}, ref_grads)


# ---- refusals ----


def _train(tmp_path, **overrides):
    train_cli.train(tiny_cfg(**overrides), str(tmp_path), "split.txt", "",
                    str(tmp_path / "run"), device="cpu")


@pytest.mark.parametrize("case", ["batch", "views", "one_process", "two_view"])
def test_refusals(case, tmp_path):
    with pytest.raises(ValueError) as exc:
        if case == "batch":
            ProcessMesh(data=2).local_batch_size(3)
        elif case == "views":
            ProcessMesh(view=2).shard_batch({"right_images": np.zeros((1, 3, 4, 4, 3))})
        elif case == "one_process":
            make_process_mesh(view=2)
        else:
            _train(tmp_path, mesh_view=2, estimate_right_idepthmap=True)
    assert {"batch": "divisible by the mesh's data size", "views": "not divisible by mesh_view",
            "one_process": "this run has one", "two_view": "two-view"}[case] in str(exc.value)

"""The port's runner over several replicas against the JAX runner's data-sharded mesh, on
the CPU.

The JAX ``StreamingRunner`` shards each batch over a mesh's ``data`` axis and replicates
a batch that does not divide by the device count; ``tests/conftest.py`` gives JAX eight
virtual CPU devices. The port keeps one replica a device and names a device twice to
hold two replicas on one host (``devices=["cpu", "cpu"]``).

- Against the JAX runner on ``make_mesh(2, view=1)``: batch 2 over a 3-sample split, so
  one step splits and the tail is replicated; every sample within FORWARD_BAR (0.2%) of
  the range of the JAX output (``tests/test_torch_model.py``'s forward bar), names in
  order.
- Two replicas against one at the same per-forward batches: bit-equal over the f32 and
  u8 transports; a float16 fetch equals the f32 output cast.
- The split: a spy on each replica's forward sees rows ``[i*b/n, (i+1)*b/n)`` on replica
  i, and a batch the replicas do not divide (the tail) whole on replica 0; ``run``
  yields the rows in sample order through the readback ring.
- Arguments: ``device`` with ``devices``, an empty ``devices``, and the default without
  a card raise. Replicas are modules of their own, replica 0 the caller's model.
- ``matmul_precision: "high"`` with K2's and K3's launches replaced by their
  TF32-rounding plain versions (``tf32_round``), so the kernel path's rounding runs
  here: two replicas bit-equal to one, and cuDNN's TF32 flag the caller's afterwards.
- The streaming CLI names the devices that served.

The runs on the card, two replicas on one card and one on each of two cards, are in
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax

from multi_view_stereonet_tpu import data as jax_data
from multi_view_stereonet_tpu.eval.streaming import StreamingRunner as JaxRunner
from multi_view_stereonet_tpu.models import MultiViewStereoNetConfig as JaxConfig
from multi_view_stereonet_tpu.parallel import make_mesh
from multi_view_stereonet_tpu_torch import data
from multi_view_stereonet_tpu_torch.eval import streaming
from multi_view_stereonet_tpu_torch.eval.streaming import StreamingRunner, main
from multi_view_stereonet_tpu_torch.models import MultiViewStereoNetConfig, mvsnet
from multi_view_stereonet_tpu_torch.ops.cuda import incremental_chain as chain
from multi_view_stereonet_tpu_torch.ops.cuda import refiner as refiner_op

from tests.test_torch_model import FORWARD_BAR, JAX_PARITY, weights
from tests.test_torch_transport import write_weights

ROWS, COLS, D = 48, 64, 4
TWO = ["cpu", "cpu"]


def bits(a):
    return np.asarray(a).view(np.int16 if a.dtype == np.float16 else np.int32)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A GTA-SfM tree of three requests."""
    from tests.synthetic_data import make_gta_sfm_tree

    root = str(tmp_path_factory.mktemp("gta"))
    return make_gta_sfm_tree(root, num_sequences=1, frames=4, rows=ROWS, cols=COLS,
                             comparisons=1)


def dataset(tree, module=data, u8=False):
    data_dir, split = tree
    kwargs = {"u8_output": True} if u8 else {}
    return module.GTASfMMultiViewDataset(
        data_dir, split, transform=module.get_testing_transforms({"size": [ROWS, COLS]},
                                                                 **kwargs),
        shuffle=False, decode_backend="pil")


def serve(runner, ds, batch_size):
    outs, names = [], []
    for idepth, batch_names in runner.run(ds, batch_size=batch_size, workers=1):
        assert type(idepth) is np.ndarray and idepth.flags.owndata
        outs.append(idepth)
        names += batch_names
    return np.concatenate(outs), names


def test_two_replicas_match_the_jax_mesh_runner(tree):
    """Batch 2 over three requests: the first step split over the two devices / replicas,
    the tail of one replicated on the mesh and served whole by replica 0."""
    assert len(jax.devices()) >= 2
    model, params = weights(seed=15)
    jax_runner = JaxRunner(params, JaxConfig(num_idepth_samples=D, **JAX_PARITY),
                           mesh=make_mesh(2, view=1))
    ref, ref_names = [], []
    for idepth, names in jax_runner.run(dataset(tree, jax_data), batch_size=2, workers=1):
        ref.append(np.asarray(idepth))
        ref_names += list(names)
    ref = np.concatenate(ref)
    runner = StreamingRunner(model, MultiViewStereoNetConfig(num_idepth_samples=D),
                             devices=TWO)
    got, names = serve(runner, dataset(tree), batch_size=2)
    assert names == ref_names and len(names) == 3 and len(set(names)) == 3
    assert got.shape == ref.shape == (3, ROWS, COLS) and np.isfinite(got).all()
    for g, r in zip(got, ref):
        span = float(r.max() - r.min())
        assert span > 0 and np.abs(g - r).max() <= FORWARD_BAR * span


@pytest.mark.parametrize("transport", ["f32", "u8", "f16"])
def test_two_replicas_are_bit_equal_to_one(tree, transport):
    """Two replicas at batch 2 (forwards of 1, 1 and the tail's 1) against one replica at
    batch 1: bit-equal over the f32 and u8 transports; the f16 fetch of two replicas is
    one replica's f32 output cast."""
    model, _ = weights(seed=3)
    config = MultiViewStereoNetConfig(num_idepth_samples=D)
    one, one_names = serve(StreamingRunner(model, config, device="cpu"), dataset(tree), 1)
    fetch = torch.float16 if transport == "f16" else None
    runner = StreamingRunner(model, config, devices=TWO, fetch_dtype=fetch)
    got, names = serve(runner, dataset(tree, u8=transport == "u8"), 2)
    assert names == one_names
    ref = one.astype(np.float16) if transport == "f16" else one
    assert got.dtype == ref.dtype and got.shape == (3, ROWS, COLS)
    np.testing.assert_array_equal(bits(got), bits(ref))


class Indexed:
    """``n`` samples of 4x6 whose left image holds the sample's index."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"left_image": np.full((4, 6, 3), i, np.float32),
                "right_images": [np.zeros((4, 6, 3), np.float32)],
                "K": np.eye(4, dtype=np.float32),
                "T_right_in_left": [np.eye(4, dtype=np.float32)],
                "left_filename": f"s{i}", "right_filenames": [f"r{i}"]}


@pytest.mark.parametrize("replicas,batch_size,in_flight", [(2, 4, 2), (2, 2, 1), (3, 3, 2)])
def test_each_replica_serves_its_rows(monkeypatch, replicas, batch_size, in_flight):
    """Seven samples: replica i of n serves rows [i*b/n, (i+1)*b/n) of every full batch and
    replica 0 the tail whole; ``run`` yields every row in sample order, through a ring
    whose slots are reused (IN_FLIGHT = 1: two slots for four steps)."""
    model, _ = weights(seed=0)
    runner = StreamingRunner(model, MultiViewStereoNetConfig(), devices=["cpu"] * replicas)
    seen = []

    def spy(served, batch, config, impl, fetch_dtype):
        index = next(i for i, r in enumerate(runner._replicas) if r.model is served)
        rows = batch["left_image"][:, 0, 0, 0].to(torch.int64).tolist()
        seen.append((index, rows))
        return batch["left_image"][..., 0] * 1.0
    monkeypatch.setattr(streaming, "serving_forward", spy)
    monkeypatch.setattr(streaming, "IN_FLIGHT", in_flight)
    got, names = serve(runner, Indexed(7), batch_size)
    assert names == [f"s{i}" for i in range(7)]
    np.testing.assert_array_equal(got[:, 0, 0], np.arange(7, dtype=np.float32))
    expected, b = [], batch_size // replicas
    for start in range(0, 7 - batch_size + 1, batch_size):
        expected += [(i, list(range(start + i * b, start + (i + 1) * b)))
                     for i in range(replicas)]
    tail = 7 % batch_size
    expected.append((0, list(range(7 - tail, 7))))
    assert seen == expected


def test_replicas_are_modules_of_their_own():
    model, _ = weights(seed=0)
    runner = StreamingRunner(model, MultiViewStereoNetConfig(), devices=TWO)
    first, second = (r.model for r in runner._replicas)
    assert runner.model is first is model and second is not model
    assert runner.devices == (torch.device("cpu"),) * 2 and runner.device.type == "cpu"
    for (name, p), (_, q) in zip(first.named_parameters(), second.named_parameters()):
        assert p is not q and torch.equal(p, q), name
    assert not any(p.is_inference() for p in second.parameters())
    assert all(r.stream is None for r in runner._replicas)  # no stream on the CPU
    with pytest.raises(AttributeError):
        runner.devices = ()


@pytest.mark.parametrize("kwargs,error", [
    ({"device": "cpu", "devices": ["cpu"]}, ValueError),
    ({"devices": []}, ValueError),
    ({}, RuntimeError)])
def test_bad_devices_raise(kwargs, error):
    """Both arguments, none named, or (by default) every card of a process with none;
    nothing falls back to the CPU."""
    model, _ = weights(seed=0)
    if not kwargs and torch.cuda.is_available():
        runner = StreamingRunner(model, MultiViewStereoNetConfig())
        assert runner.devices == tuple(torch.device("cuda", i)
                                       for i in range(torch.cuda.device_count()))
        return
    with pytest.raises(error):
        StreamingRunner(model, MultiViewStereoNetConfig(), **kwargs)


@pytest.mark.parametrize("caller_flag", [False, True])
def test_two_replicas_at_high_are_bit_equal_to_one(tree, monkeypatch, caller_flag):
    """K2's and K3's launches run their TF32-rounding plain versions in a "tf32" scope
    (the kernel path on CPU tensors), so "high" rounds here as the 1xTF32 kernels do: two
    replicas bit-equal to one, both off "highest", cuDNN's TF32 flag on at each launch
    and the caller's again after the run."""
    flags = []

    def k2(refiner, feats0, image_rest, H_inc, cluster, tf32):
        flags.append((tf32, torch.backends.cudnn.allow_tf32))
        plain = chain.incremental_chain_tf32_plain if tf32 else chain.incremental_chain_plain
        return plain(refiner, feats0, image_rest, H_inc)

    def k3(refiner, guidance, idepth, tf32):
        flags.append((tf32, torch.backends.cudnn.allow_tf32))
        plain = (refiner_op.idepthmap_refiner_tf32_plain if tf32
                 else refiner_op.idepthmap_refiner_plain)
        return plain(refiner, guidance, idepth)
    monkeypatch.setattr(chain, "_launch", k2)
    monkeypatch.setattr(refiner_op, "_launch", k3)
    for module in (mvsnet, chain, refiner_op):
        monkeypatch.setattr(module, "use_kernel", lambda impl, t: impl != "plain")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", caller_flag)
    model, _ = weights(seed=4)
    outs = {}
    for precision in ("high", "highest"):
        config = MultiViewStereoNetConfig(num_idepth_samples=D, matmul_precision=precision)
        outs[precision, 1] = serve(StreamingRunner(model, config, device="cpu"),
                                   dataset(tree), 1)[0]
        assert torch.backends.cudnn.allow_tf32 is caller_flag
    config = MultiViewStereoNetConfig(num_idepth_samples=D, matmul_precision="high")
    flags.clear()
    outs["high", 2] = serve(StreamingRunner(model, config, devices=TWO), dataset(tree), 2)[0]
    assert torch.backends.cudnn.allow_tf32 is caller_flag
    # Three forwards, each K2 once and K3 at every level (48x64 is within 60x80).
    assert len(flags) == 3 * 6 and all(f == (True, True) for f in flags)
    np.testing.assert_array_equal(bits(outs["high", 2]), bits(outs["high", 1]))
    assert not np.array_equal(outs["high", 1], outs["highest", 1])


def test_streaming_cli_names_the_devices_that_served(tree, tmp_path, capsys):
    data_dir, split = tree
    weights_dir = write_weights(tmp_path)
    main([weights_dir, data_dir, split, "--batch_size", "2", "--workers", "1",
          "--decode_backend", "pil", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.split()[0] == "3" and "on 1 × cpu," in out
    assert streaming.describe_devices([torch.device("cpu")] * 2) == "2 × cpu"
    if not torch.cuda.is_available():  # --device cuda: every card, and there is none
        with pytest.raises(RuntimeError, match="CUDA"):
            main([weights_dir, data_dir, split, "--device", "cuda"])

"""The port's serving transport against the JAX package, on the CPU.

- ``ops/quantize.py``: ``dequantize_images_u8`` and ``dequantize_images_u8_unit``
  bit-equal, for all 256 values, to the host pipeline (``data/transforms.py``
  ToArray + Normalize, and ToArray alone) and to the JAX functions;
  ``quantize_images_u8`` inverts them.
- ``StreamingRunner``: outputs bit-equal across the f32 transport, f32 batches
  quantized on the host and a u8 dataset (as ``tests/test_streaming.py`` holds
  the JAX runner); ``fetch_dtype=torch.float16`` equal to the f32 output cast;
  ``run`` yields numpy arrays of their own, read back through a ring of
  ``IN_FLIGHT + 1`` reused buffers; with no device it asks for the card.
- ``ShardedDataset`` and the streaming CLI's shard, u8 and f16 flags.
"""

import numpy as np
import pytest
import torch
import yaml

import jax

from multi_view_stereonet_tpu.ops import quantize as jax_quantize
from multi_view_stereonet_tpu.parallel import ShardedDataset as JaxShardedDataset
from multi_view_stereonet_tpu_torch import data
from multi_view_stereonet_tpu_torch.checkpoint import random_state_dict
from multi_view_stereonet_tpu_torch.eval import streaming
from multi_view_stereonet_tpu_torch.eval.streaming import (
    IN_FLIGHT, WEIGHTS_FILE, ReadbackRing, StreamingRunner, main, serving_device)
from multi_view_stereonet_tpu_torch.models import MultiViewStereoNetConfig
from multi_view_stereonet_tpu_torch.ops import quantize
from multi_view_stereonet_tpu_torch.parallel import ShardedDataset

from tests.synthetic_data import make_gta_sfm_tree
from tests.test_torch_model import weights

ROWS, COLS, D = 48, 64, 4
U8 = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1)


def bits(a):
    return np.asarray(a).view(np.int32)


def test_dequantize_is_bit_exact_for_all_256_values():
    unit = U8.astype(np.float32) / 255.0            # ToArray
    full = unit * 2.0 - 1.0                         # Normalize
    got_full = quantize.dequantize_images_u8(torch.from_numpy(U8)).numpy()
    got_unit = quantize.dequantize_images_u8_unit(torch.from_numpy(U8)).numpy()
    assert got_full.dtype == got_unit.dtype == np.float32
    np.testing.assert_array_equal(bits(got_full), bits(full))
    np.testing.assert_array_equal(bits(got_unit), bits(unit))
    np.testing.assert_array_equal(
        bits(got_full), bits(jax.jit(jax_quantize.dequantize_images_u8)(U8)))
    np.testing.assert_array_equal(
        bits(got_unit), bits(jax.jit(jax_quantize.dequantize_images_u8_unit)(U8)))
    np.testing.assert_array_equal(quantize.quantize_images_u8(full), U8)
    np.testing.assert_array_equal(quantize.quantize_images_u8(full),
                                  jax_quantize.quantize_images_u8(full))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("gta"))
    data_dir, split = make_gta_sfm_tree(root, num_sequences=1, frames=4, rows=ROWS,
                                        cols=COLS, comparisons=1)
    return root, data_dir, split


def dataset(tree, u8=False):
    _, data_dir, split = tree
    return data.GTASfMMultiViewDataset(
        data_dir, split, transform=data.get_testing_transforms({"size": [ROWS, COLS]},
                                                               u8_output=u8),
        shuffle=False, decode_backend="pil")


class Quantized:
    """An f32 dataset with its images quantized back to uint8 on the host."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        sample = dict(self.ds[i])
        sample["left_image"] = quantize.quantize_images_u8(sample["left_image"])
        sample["right_images"] = [quantize.quantize_images_u8(r)
                                  for r in sample["right_images"]]
        return sample


def serve(runner, ds, batch_size=2):
    outs, names = [], []
    for idepth, batch_names in runner.run(ds, batch_size=batch_size, workers=1):
        assert type(idepth) is np.ndarray and idepth.flags.owndata
        outs.append(idepth)
        names += batch_names
    return np.concatenate(outs), names


def test_u8_transports_serve_the_f32_bits(tree):
    """Three transports, one result: f32, f32 images quantized to uint8 on the host,
    and a dataset that emits uint8 straight from the decoder; the images' dtype alone
    selects the transport. The split has 3 samples: batch 2 leaves a partial batch."""
    model, _ = weights(seed=3)
    config = MultiViewStereoNetConfig(num_idepth_samples=D)
    runner = StreamingRunner(model, config, device="cpu")
    outs = {key: serve(runner, ds) for key, ds in (
        ("f32", dataset(tree)), ("quantized", Quantized(dataset(tree))),
        ("u8", dataset(tree, u8=True)))}
    got, names = outs["f32"]
    assert got.shape == (3, ROWS, COLS) and got.dtype == np.float32
    assert np.isfinite(got).all() and got.max() > got.min()
    for key in ("quantized", "u8"):
        assert outs[key][1] == names
        np.testing.assert_array_equal(bits(outs[key][0]), bits(got))


def test_fetch_f16_is_the_f32_output_cast(tree):
    model, _ = weights(seed=3)
    config = MultiViewStereoNetConfig(num_idepth_samples=D)
    f32, _ = serve(StreamingRunner(model, config, device="cpu"), dataset(tree))
    f16, _ = serve(StreamingRunner(model, config, device="cpu", fetch_dtype=torch.float16),
                   dataset(tree, u8=True))
    assert f16.dtype == np.float16
    np.testing.assert_array_equal(f16, f32.astype(np.float16))


def test_runner_serves_on_the_card_unless_told_otherwise():
    """No device: the card, which this process must have; it never serves on the CPU
    because the model happens to be there."""
    model, _ = weights(seed=0)
    if torch.cuda.is_available():
        assert StreamingRunner(model, MultiViewStereoNetConfig()).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamingRunner(model, MultiViewStereoNetConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        serving_device()
    assert serving_device("cpu") == torch.device("cpu")
    runner = StreamingRunner(model, MultiViewStereoNetConfig(), device="cpu",
                             fetch_dtype=torch.float16)
    assert runner.fetch_dtype == torch.float16
    with pytest.raises(AttributeError):
        runner.fetch_dtype = None


def test_readback_ring_reuses_its_buffers():
    """Step k's slot is written again at step k + IN_FLIGHT + 1 and not before; a new
    shape or dtype (the trailing partial batch, a float16 fetch) takes a new buffer."""
    slots = IN_FLIGHT + 1
    ring = ReadbackRing(slots, pin_memory=False)
    shape = torch.Size((2, ROWS, COLS))
    taken = [ring.take(step, shape, torch.float32) for step in range(3 * slots)]
    for step, buf in enumerate(taken):
        assert buf.shape == shape and buf.dtype == torch.float32
        window = taken[max(0, step - slots + 1):step + 1]
        assert len({b.data_ptr() for b in window}) == len(window)
        if step >= slots:
            assert buf is taken[step - slots]
    tail = ring.take(3 * slots, torch.Size((1, ROWS, COLS)), torch.float32)
    assert tail is not taken[0] and tail.shape == (1, ROWS, COLS)
    assert ring.take(3 * slots + slots, tail.shape, torch.float32) is tail
    assert ring.take(0, shape, torch.float16).dtype == torch.float16


def test_run_reads_back_through_the_ring(tree, monkeypatch):
    """With one step in flight, a run of 3 batches of 1 reads back through 2 host
    buffers, so step 2 rewrites step 0's; the arrays it yields are copies and equal a
    run that reuses no buffer (IN_FLIGHT = 2: 3 slots for 3 steps)."""
    model, _ = weights(seed=3)
    runner = StreamingRunner(model, MultiViewStereoNetConfig(num_idepth_samples=D),
                             device="cpu")
    ref, _ = serve(runner, dataset(tree), batch_size=1)

    allocated = []
    take = ReadbackRing.take

    def recording_take(self, step, shape, dtype):
        buf = take(self, step, shape, dtype)
        allocated.append(buf.data_ptr())
        return buf

    monkeypatch.setattr(streaming.ReadbackRing, "take", recording_take)
    monkeypatch.setattr(streaming, "IN_FLIGHT", 1)
    got, _ = serve(runner, dataset(tree), batch_size=1)
    assert len(allocated) == 3 and allocated[2] == allocated[0] != allocated[1]
    np.testing.assert_array_equal(bits(got), bits(ref))


@pytest.mark.parametrize("process_count", [3, 4])
def test_sharded_dataset_covers_every_sample_once(process_count):
    """Without ``drop_ragged_tail``, as the streaming CLI's fleet shards take it."""
    samples = list(range(10))
    shards = [ShardedDataset(samples, i, process_count, drop_ragged_tail=False)
              for i in range(process_count)]
    seen = sorted(s for shard in shards for s in (shard[j] for j in range(len(shard))))
    assert seen == samples
    for i, shard in enumerate(shards):
        ref = JaxShardedDataset(samples, i, process_count, drop_ragged_tail=False)
        assert [shard[j] for j in range(len(shard))] == [ref[j] for j in range(len(ref))]
    with pytest.raises(ValueError):
        ShardedDataset(samples, process_count, process_count)


def write_weights(tmp_path):
    run_dir = tmp_path / "run"
    weights_dir = run_dir / "checkpoints" / "epoch0000"
    weights_dir.mkdir(parents=True)
    (run_dir / "params.yaml").write_text(yaml.safe_dump(
        {"size": [ROWS, COLS], "num_idepth_samples": D}))
    torch.save(random_state_dict(3), str(weights_dir / WEIGHTS_FILE))
    return str(weights_dir)


@pytest.mark.parametrize("shard_id,num_shards", [(2, 2), (-1, 1), (0, 0)])
def test_streaming_cli_refuses_a_bad_shard(tmp_path, shard_id, num_shards, capsys):
    with pytest.raises(SystemExit):
        main([str(tmp_path), str(tmp_path), "gta_sfm_test.txt", "--shard_id",
              str(shard_id), "--num_shards", str(num_shards), "--device", "cpu"])
    assert "--shard_id" in capsys.readouterr().err


def test_streaming_cli_serves_its_shard_over_the_u8_transport(tree, tmp_path, capsys):
    _, data_dir, split = tree
    weights_dir = write_weights(tmp_path)
    counts = []
    for shard_id in (0, 1):
        main([weights_dir, data_dir, split, "--batch_size", "2", "--workers", "1",
              "--decode_backend", "pil", "--device", "cpu", "--transfer_u8", "--fetch_f16",
              "--shard_id", str(shard_id), "--num_shards", "2"])
        counts.append(int(capsys.readouterr().out.split()[0]))
    assert counts == [2, 1]

"""The port's weight readers against the JAX package's, on the CPU.

- The reference's TorchScript ``stereo_network.pt``: an archive written by
  ``torch.jit.save`` of a scripted module tree with the reference's names, the right
  extractor's shared copies of the left's weights and one strided parameter at an
  offset (``tests/reference_archive.py``). The port's ``load_torchscript_weights``
  gives every tensor bit-equal to the JAX ``load_torchscript_weights``, also with the
  archive's root renamed; its state dict equals ``state_dict_from_jax_params(
  convert_reference_state_dict(...))`` bit for bit. A missing name or a wrong shape
  raises, naming it.
- The JAX package's ``stereo_network.msgpack``, written by its ``save_params``: the
  port's ``load_any_params`` equals ``state_dict_from_jax_params`` of the params bit for
  bit, without importing ``msgpack`` or ``flax``; the decoder against the ``msgpack``
  package on every type of the subset.
- ``load_any_params``'s precedence (.pth, .msgpack, .pt) and its errors.
- The eval CLI from a ``.pt`` directory: the same metric files as from ``.pth``, and
  within ``tests/test_torch_eval.py``'s bars of the JAX ``run_eval`` on the same ``.pt``.
"""

import os
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch
import yaml

import jax

from multi_view_stereonet_tpu.checkpoint import convert_reference_state_dict
from multi_view_stereonet_tpu.checkpoint import load_torchscript_weights as jax_load_ts
from multi_view_stereonet_tpu.checkpoint.native import load_params as jax_load_params
from multi_view_stereonet_tpu.checkpoint.native import save_params as jax_save_params
from multi_view_stereonet_tpu.eval.test_cli import run_eval as jax_run_eval
from multi_view_stereonet_tpu.models import init_mvsnet
from multi_view_stereonet_tpu_torch.checkpoint import (
    load_any_params, load_torchscript_weights, random_state_dict, state_dict_from_jax_params,
    state_dict_from_reference)
from multi_view_stereonet_tpu_torch.checkpoint import msgpack as port_msgpack
from multi_view_stereonet_tpu_torch.checkpoint.native import (
    MSGPACK_FILE, PARAMS_FILE, TORCHSCRIPT_FILE)
from multi_view_stereonet_tpu_torch.eval import test_cli

from tests.reference_archive import STRIDED, write_reference_archive
from tests.synthetic_data import make_gta_sfm_tree
from tests.test_torch_eval import all_files, assert_outputs_match

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 5


def assert_state_dicts_equal(got: dict, ref: dict):
    assert list(got) == list(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype == torch.float32, k
        assert got[k].is_contiguous(), k
        assert torch.equal(got[k], ref[k]), k


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ts") / TORCHSCRIPT_FILE)
    params = write_reference_archive(random_state_dict(SEED), path)
    return path, params


def renamed_root(path, root, out):
    """A copy of the archive at ``path`` with its root directory named ``root``."""
    with zipfile.ZipFile(path) as src, zipfile.ZipFile(out, "w") as dst:
        for info in src.infolist():
            dst.writestr(root + "/" + info.filename.split("/", 1)[1], src.read(info))
    return out


@pytest.mark.parametrize("root", [None, "MultiViewStereoNet"])
def test_torchscript_reader_matches_jax(archive, root, tmp_path):
    """Every tensor, the shared copies and the strided one included, bit-equal to the JAX
    reader's, with the archive's own root and with a root named after the module."""
    path, params = archive
    if root is not None:
        path = renamed_root(path, root, str(tmp_path / "renamed.pt"))
    got = load_torchscript_weights(path)
    ref = jax_load_ts(path)
    assert sorted(got) == sorted(ref) == sorted(params)
    assert not params[STRIDED].is_contiguous() and params[STRIDED].storage_offset() > 0
    for k, v in ref.items():
        assert got[k].numpy().dtype == v.dtype, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_torchscript_state_dict_equals_the_jax_conversion(archive):
    path, _ = archive
    sd = state_dict_from_reference(load_torchscript_weights(path))
    ref = state_dict_from_jax_params(convert_reference_state_dict(jax_load_ts(path)))
    assert_state_dicts_equal(sd, ref)
    assert_state_dicts_equal(sd, random_state_dict(SEED))
    assert_state_dicts_equal(load_any_params(os.path.dirname(path)), ref)


@pytest.mark.parametrize("fault", ["missing", "shape"])
def test_torchscript_fault_is_named(fault, tmp_path):
    name = "refiner1.bn0.bias"
    kwargs = {"drop": (name,)} if fault == "missing" else {"shapes": {name: (31,)}}
    write_reference_archive(random_state_dict(SEED), str(tmp_path / TORCHSCRIPT_FILE),
                            **kwargs)
    with pytest.raises(ValueError, match=name):
        load_any_params(str(tmp_path))


@pytest.fixture(scope="module")
def jax_params():
    return jax.device_get(init_mvsnet(jax.random.PRNGKey(2)))


def test_msgpack_weights_equal_the_jax_params(jax_params, tmp_path):
    jax_save_params(str(tmp_path), jax_params)
    assert os.listdir(tmp_path) == [MSGPACK_FILE]
    ref = state_dict_from_jax_params(jax_params)
    assert_state_dicts_equal(load_any_params(str(tmp_path)), ref)
    # and the JAX package's own reader of the file agrees
    back = jax_load_params(str(tmp_path))
    assert_state_dicts_equal(state_dict_from_jax_params(jax.device_get(back)), ref)


def test_port_reads_msgpack_without_msgpack_or_flax(jax_params, tmp_path):
    """Every module of the port imported and a msgpack file read, in a fresh process:
    neither ``msgpack`` nor ``flax`` is imported."""
    jax_save_params(str(tmp_path), jax_params)
    code = (
        "import importlib, pkgutil, sys\n"
        "import multi_view_stereonet_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "from multi_view_stereonet_tpu_torch.checkpoint import load_any_params\n"
        f"sd = load_any_params({str(tmp_path)!r})\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('msgpack', 'flax')]\n"
        "assert not bad, bad\n"
        "print(len(sd))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert int(proc.stdout.split()[-1]) == len(random_state_dict())


def test_msgpack_decoder_matches_the_msgpack_package():
    """Every type of the subset flax writes, at each of its widths, as the ``msgpack``
    package packs and reads it; an ndarray ext as flax packs it; other ext types and
    trailing bytes raise."""
    import msgpack
    from flax import serialization

    obj = {"ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32, 2**63 - 1, -1, -32,
                    -33, -128, -129, -32768, -32769, -2**31 - 1, -2**63],
           "floats": [0.5, -1e300, float("inf")], "nil": None, "bools": [True, False],
           "str": ["", "a" * 31, "b" * 32, "c" * 256, "d" * 65536, "é"],
           "bin": [b"", b"x" * 300, b"y" * 70000], "map16": {str(i): i for i in range(20)},
           "list16": list(range(20))}
    for single in (False, True):
        data = msgpack.packb(obj, use_bin_type=True, use_single_float=single)
        assert port_msgpack.unpackb(data) == msgpack.unpackb(data, raw=False,
                                                             strict_map_key=False)
    arrays = {"a": np.arange(24, dtype=np.float32).reshape(2, 3, 4),
              "b": {"c": np.array([1, -2], dtype=np.int64), "d": np.zeros((0, 3))},
              "e": np.array(2.5, dtype=np.float16)}
    got = port_msgpack.unpackb(serialization.msgpack_serialize(arrays))
    for path, ref in (("a", arrays["a"]), ("b/c", arrays["b"]["c"]),
                      ("b/d", arrays["b"]["d"]), ("e", arrays["e"])):
        leaf = got
        for key in path.split("/"):
            leaf = leaf[key]
        assert leaf.dtype == ref.dtype and leaf.shape == ref.shape, path
        np.testing.assert_array_equal(leaf, ref, err_msg=path)
    with pytest.raises(ValueError, match="ext type 5"):
        port_msgpack.unpackb(msgpack.packb(msgpack.ExtType(5, b"abc")))
    with pytest.raises(ValueError, match="trailing"):
        port_msgpack.unpackb(msgpack.packb(1) + b"\x00")


def test_load_any_params_precedence_and_errors(jax_params, tmp_path):
    """.pth before .msgpack before .pt; with none, a FileNotFoundError naming all three;
    a .pth that does not fit the network raises, naming the name."""
    d = str(tmp_path)
    with pytest.raises(FileNotFoundError) as err:
        load_any_params(d)
    for name in (PARAMS_FILE, MSGPACK_FILE, TORCHSCRIPT_FILE):
        assert name in str(err.value)
    write_reference_archive(random_state_dict(SEED), os.path.join(d, TORCHSCRIPT_FILE))
    jax_save_params(d, jax_params)
    torch.save(random_state_dict(7), os.path.join(d, PARAMS_FILE))
    assert_state_dicts_equal(load_any_params(d), random_state_dict(7))
    os.remove(os.path.join(d, PARAMS_FILE))
    assert_state_dicts_equal(load_any_params(d), state_dict_from_jax_params(jax_params))
    os.remove(os.path.join(d, MSGPACK_FILE))
    assert_state_dicts_equal(load_any_params(d), random_state_dict(SEED))
    sd = random_state_dict(7)
    sd["refiner0.extra.weight"] = sd.pop("refiner0.conv0.bias")
    torch.save(sd, os.path.join(d, PARAMS_FILE))
    with pytest.raises(ValueError, match="missing refiner0.conv0.bias.*unexpected "
                                         "refiner0.extra.weight"):
        load_any_params(d)


def test_eval_cli_reads_the_reference_archive(tmp_path):
    """``run_eval`` from a ``.pt`` directory writes the metric files of the ``.pth``
    directory's run, value for value, and agrees with the JAX ``run_eval`` of the same
    ``.pt`` within ``tests/test_torch_eval.py``'s bars (64x80, D = 4, GTA V = 1)."""
    rows, cols = 64, 80
    data_dir, split = make_gta_sfm_tree(str(tmp_path / "gta"), num_sequences=1, frames=3,
                                        rows=rows, cols=cols, comparisons=1)
    sd = random_state_dict(3)  # tests/test_torch_eval.py's seed, for its bars
    weights = {}
    for kind in ("pth", "pt"):
        run_dir = tmp_path / kind
        weights[kind] = str(run_dir / "checkpoints" / "epoch0000")
        os.makedirs(weights[kind])
        with open(run_dir / "params.yaml", "w") as f:
            yaml.safe_dump({"size": [rows, cols], "num_idepth_samples": 4,
                            "matmul_precision": "highest"}, f)
    torch.save(sd, os.path.join(weights["pth"], PARAMS_FILE))
    write_reference_archive(sd, os.path.join(weights["pt"], TORCHSCRIPT_FILE))
    outs = {}
    for kind, w in weights.items():
        outs[kind] = str(tmp_path / f"port_{kind}")
        test_cli.run_eval(w, data_dir, split, outs[kind], decode_backend="pil", device="cpu")
    files = all_files(outs["pth"])
    assert files == all_files(outs["pt"]) and "depth_metrics.txt" in files
    for name in files:
        if "runtime" in name:
            continue
        got, ref = (open(os.path.join(outs[k], name)).read() for k in ("pt", "pth"))
        assert got == ref, name
    jax_out = str(tmp_path / "jax_pt")
    jax_run_eval(weights["pt"], data_dir, split, jax_out, decode_backend="pil")
    assert_outputs_match(outs["pt"], jax_out)

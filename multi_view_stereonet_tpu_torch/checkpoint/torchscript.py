"""The reference's TorchScript checkpoints (``stereo_network.pt``), read without ``torch.jit``.

Port of ``multi_view_stereonet_tpu/checkpoint/torchscript.py``. The reference ships
its pretrained networks as TorchScript archives (the file its ``test.py`` loads with
``torch.jit.load``). Those embed torch-1.5 scripted code that current torch refuses to
compile again, so the archive is read as what it is: a zip whose ``<root>/data.pkl``
pickles the module tree, each tensor a view (offset, size, stride) of a raw
little-endian storage under ``<root>/data/<key>``. The root is named after the saved
module or file, so it is taken from the archive's first entry. A restricted unpickler
rebuilds the tree from stand-ins and the tensors as torch tensors; any class outside
TorchScript's module, tensor and storage classes raises.

``state_dict_from_reference`` then selects the port's state dict: the port's modules
carry the reference's names (``checkpoint/convert.py``), so the map is the selection of
the names the JAX ``convert_reference_state_dict`` reads. The right extractor's copy of
the left extractor's weights (reference ``multi_view_stereonet.py:507``) and any other
name are dropped.
"""

from __future__ import annotations

import collections
import io
import pickle
import zipfile

import torch

from .convert import check_state_dict, expected_shapes

_DTYPES = {
    "FloatStorage": torch.float32,
    "DoubleStorage": torch.float64,
    "HalfStorage": torch.float16,
    "BFloat16Storage": torch.bfloat16,
    "LongStorage": torch.int64,
    "IntStorage": torch.int32,
    "ShortStorage": torch.int16,
    "CharStorage": torch.int8,
    "ByteStorage": torch.uint8,
    "BoolStorage": torch.bool,
}


class _Module:
    """Stand-in for a pickled scripted module: keeps the state it is given."""

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        self.__dict__.update(state if isinstance(state, dict) else {"_state": state})


def _rebuild_tensor(storage, offset, size, stride, *unused):
    dtype, data = storage
    flat = torch.frombuffer(bytearray(data), dtype=dtype) if data else torch.empty(
        0, dtype=dtype)
    return flat.as_strided(tuple(size), tuple(stride), offset).clone()


class _Unpickler(pickle.Unpickler):
    def __init__(self, file, storages: dict):
        super().__init__(file)
        self._storages = storages

    def persistent_load(self, pid):
        kind, storage_class, key = pid[:3]
        if kind != "storage" or storage_class not in _DTYPES:
            raise pickle.UnpicklingError(f"unsupported persistent id {pid!r}")
        return _DTYPES[storage_class], self._storages[key]

    def find_class(self, module, name):
        if module == "torch._utils" and name == "_rebuild_tensor_v2":
            return _rebuild_tensor
        if module == "torch" and name in _DTYPES:
            return name
        if module == "torch.jit._pickle" and name.startswith("build_"):
            return list
        if module == "collections" and name == "OrderedDict":
            return collections.OrderedDict
        if module.startswith("__torch__."):
            return type(name, (_Module,), {})
        raise pickle.UnpicklingError(f"a TorchScript weights archive holds no {module}.{name}")


def _collect(obj, prefix: str, out: dict) -> None:
    for key, value in vars(obj).items():
        if key.startswith("_") or key == "training":
            continue
        name = f"{prefix}.{key}" if prefix else key
        if isinstance(value, torch.Tensor):
            out[name] = value
        elif isinstance(value, _Module):
            _collect(value, name, out)


def load_torchscript_weights(path: str) -> dict:
    """Every tensor of a TorchScript archive, ``{dotted name: CPU tensor}``."""
    with zipfile.ZipFile(path) as z:
        names = z.namelist()
        root = names[0].split("/")[0]
        storages = {}
        for n in names:
            parts = n.split("/")
            if len(parts) == 3 and parts[0] == root and parts[1] == "data":
                storages[parts[2]] = z.read(n)
        module = _Unpickler(io.BytesIO(z.read(f"{root}/data.pkl")), storages).load()
    tensors: dict = {}
    _collect(module, "", tensors)
    return tensors


def state_dict_from_reference(tensors: dict) -> dict:
    """The port's state dict from the reference's named tensors: the port's names
    selected, float32 and contiguous. A missing name or a wrong shape raises and names
    it."""
    sd = {k: tensors[k].to(torch.float32).contiguous() for k in expected_shapes()
          if k in tensors}
    check_state_dict(sd, "the reference weights")
    return sd


def load_torchscript_state_dict(path: str) -> dict:
    """The port's state dict from a reference ``stereo_network.pt``."""
    return state_dict_from_reference(load_torchscript_weights(path))

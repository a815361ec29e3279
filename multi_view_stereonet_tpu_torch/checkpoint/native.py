"""Checkpoints: the network's weights and the training state, one directory an epoch.

Port of ``multi_view_stereonet_tpu/checkpoint/native.py`` in the same layout,
``<root>/epochNNNN[<suffix>]/`` (suffix "-nanabort" for the dump of a run that hit
a non-finite loss), with ``torch.save`` files in place of flax's msgpack and
orbax:

- ``stereo_network.pth``: the model's state dict, the file ``run_eval`` and the
  streaming CLI read (``eval/streaming.py`` ``load_model``), so a trained epoch
  evaluates as it is;
- ``state.pth``: ``{"model": state dict, "optimizer": the train step's optimizer
  state, "step": steps taken}``.

Files are written under a temporary name and renamed, so a run stopped mid-write
leaves no half-written checkpoint under the final name.
"""

from __future__ import annotations

import os
import re

import torch

PARAMS_FILE = "stereo_network.pth"
STATE_FILE = "state.pth"


def _to_cpu(tree):
    """A copy of a nest of dicts, lists and tuples with every tensor on the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def _save(obj, path: str):
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(_to_cpu(obj), tmp)
    os.replace(tmp, path)


def _state_dict(model_or_state):
    return (model_or_state.state_dict() if isinstance(model_or_state, torch.nn.Module)
            else model_or_state)


def save_params(directory: str, model_or_state) -> str:
    """Write a model's (or a state dict's) weights to ``<directory>/stereo_network.pth``."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, PARAMS_FILE)
    _save(_state_dict(model_or_state), path)
    return path


def load_params(directory_or_file: str) -> dict:
    """The state dict of ``stereo_network.pth`` (a directory holding it, or the file),
    on the CPU."""
    path = directory_or_file
    if os.path.isdir(path):
        path = os.path.join(path, PARAMS_FILE)
    return torch.load(path, map_location="cpu", weights_only=True)


def epoch_dir(root: str, epoch: int) -> str:
    return os.path.join(root, f"epoch{epoch:04d}")


def save_train_state(root: str, epoch: int, model_or_state, optimizer_state: dict,
                     step: int, suffix: str = "") -> str:
    """Write ``<root>/epochNNNN<suffix>/`` with ``state.pth`` and ``stereo_network.pth``;
    returns the directory. A ``suffix`` ("-nanabort") keeps an abnormal dump apart from
    the epoch checkpoints: ``latest_epoch`` never takes it."""
    path = os.path.abspath(epoch_dir(root, epoch) + suffix)
    os.makedirs(path, exist_ok=True)
    model_state = _state_dict(model_or_state)
    _save({"model": model_state, "optimizer": optimizer_state, "step": int(step)},
          os.path.join(path, STATE_FILE))
    save_params(path, model_state)
    return path


def load_train_state(root: str, epoch: int) -> dict:
    """``{"model", "optimizer", "step"}`` of epoch ``epoch`` under ``root``, on the CPU."""
    return torch.load(os.path.join(epoch_dir(root, epoch), STATE_FILE), map_location="cpu",
                      weights_only=True)


def latest_epoch(root: str) -> int | None:
    """The last epoch with a checkpoint (``epochNNNN``, no suffix) under ``root``."""
    if not os.path.isdir(root):
        return None
    epochs = [int(m.group(1)) for m in (re.fullmatch(r"epoch(\d{4})", name)
                                        for name in os.listdir(root)) if m]
    return max(epochs) if epochs else None

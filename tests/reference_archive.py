"""Write a TorchScript archive laid out as the reference's ``stereo_network.pt``.

The reference network's parameters carry the names of the port's state dict, and its
right feature extractor shares the left extractor's weights (reference
``multi_view_stereonet.py:507``): the archive holds those shared names too. One
parameter is stored as a strided view at an offset into a larger storage, as an archive
may hold it. ``torch.jit.save`` of a scripted tree of plain ``nn.Module``s writes the
same zip and pickle layout the reference's archives use: the readers never run its code.
"""

from __future__ import annotations

import torch
from torch import nn

STRIDED = "refiner2.conv0.weight"
OFFSET = 7


def strided_copy(t: torch.Tensor, offset: int = OFFSET) -> torch.Tensor:
    """``t`` (4-D) as a non-contiguous view at ``offset`` into a larger storage: its
    output-channel axis innermost in memory."""
    base = t.permute(1, 2, 3, 0).contiguous()
    storage = torch.zeros(offset + base.numel() + 5)
    storage[offset:offset + base.numel()] = base.reshape(-1)
    view = storage.as_strided(t.shape, base.permute(3, 0, 1, 2).stride(), offset)
    assert torch.equal(view, t) and not view.is_contiguous()
    return view


def reference_parameters(state_dict: dict, drop=(), shapes=None) -> dict:
    """The reference's named parameters for a port state dict: every name, the right
    extractor's shared copies of the left's, ``STRIDED`` as a strided view; names in
    ``drop`` left out, tensors in ``shapes`` given another shape."""
    params = {}
    for name, t in state_dict.items():
        if name in drop:
            continue
        t = t.detach().clone()
        if shapes and name in shapes:
            t = torch.zeros(shapes[name])
        params[name] = nn.Parameter(strided_copy(t) if name == STRIDED else t,
                                    requires_grad=False)
    for name in list(params):
        if name.startswith("left_feature_extractor."):
            params["right_feature_extractor." + name.split(".", 1)[1]] = params[name]
    return params


def write_reference_archive(state_dict: dict, path: str, drop=(), shapes=None) -> dict:
    """``torch.jit.save`` a scripted module tree holding ``reference_parameters``; returns
    those parameters by name."""
    params = reference_parameters(state_dict, drop, shapes)
    root = nn.Module()
    for name, p in params.items():
        *path_names, leaf = name.split(".")
        module = root
        for part in path_names:
            if not hasattr(module, part):
                module.add_module(part, nn.Module())
            module = getattr(module, part)
        module.register_parameter(leaf, p)
    torch.jit.save(torch.jit.script(root), path)
    return params

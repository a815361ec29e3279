"""Weights: the JAX param pytree <-> the port's state dict, and a seeded initialiser.

``state_dict_from_jax_params`` maps the JAX package's param pytree
(``models/mvsnet.py:178-191`` ``init_mvsnet`` layout, numpy arrays, conv
kernels HWIO / DHWIO) onto the port's state dict (reference names, kernels
OIHW / OIDHW). It is the exact inverse of the JAX package's
``checkpoint/torchscript.py`` ``convert_reference_state_dict``.

``init_params_numpy`` draws that pytree from a seed with numpy only, at
fan-in scale: conv weights N(0, 1 / fan_in), biases N(0, 0.1^2),
GroupNorm scale 1 + N(0, 0.1^2) and bias N(0, 0.1^2). The reference's
N(0, 0.01) init makes the refiner deltas so small that a broken refiner
could pass a comparison; these weights do not. ``init_params_numpy(seed,
reference=True)`` draws the reference's init instead (the JAX package's
``init_mvsnet``: conv weights N(0, 0.01^2), biases 0, GroupNorm scale 1 and
bias 0), which training starts from; numpy's draws are not JAX's.
"""

from __future__ import annotations

import numpy as np
import torch

FEATURE_CHANNELS = 32
DILATED_RES_BLOCKS = 6


def _hwio_to_oihw(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (3, 2, 0, 1) if w.ndim == 4 else (4, 3, 0, 1, 2))


def _conv(sd, name, p):
    sd[f"{name}.weight"] = _hwio_to_oihw(np.asarray(p["w"]))
    if "b" in p:
        sd[f"{name}.bias"] = np.asarray(p["b"])


def _gn(sd, name, p):
    sd[f"{name}.weight"] = np.asarray(p["scale"])
    sd[f"{name}.bias"] = np.asarray(p["bias"])


def _res(sd, name, p):
    _conv(sd, f"{name}.conv1", p["conv"])
    _gn(sd, f"{name}.bn1", p["gn"])


def state_dict_from_jax_params(params) -> dict:
    """JAX param pytree (numpy leaves) -> state dict of float32 CPU tensors."""
    sd: dict = {}
    fn = params["feature_network"]
    pre = "left_feature_extractor"
    for i in range(4):
        _conv(sd, f"{pre}.conv{i}", fn[f"conv{i}"])
    for i in range(6):
        _res(sd, f"{pre}.res{i}", fn[f"res{i}"])
    _conv(sd, f"{pre}.conv_final", fn["conv_final"])

    fr = params["feature_refiner"]
    pre = "right_feature_extractor.refiner"
    _conv(sd, f"{pre}.conv0", fr["conv0"])
    _gn(sd, f"{pre}.bn0", fr["gn0"])
    _res(sd, f"{pre}.res0", fr["res0"])
    _conv(sd, f"{pre}.conv_final", fr["conv_final"])

    vf = params["volume_filter4"]
    for i in range(4):
        _conv(sd, f"volume_filter4.conv{i}", vf[f"conv{i}"])
        _gn(sd, f"volume_filter4.bn{i}", vf[f"gn{i}"])
    _conv(sd, "volume_filter4.conv4", vf["conv4"])

    for lvl in range(5):
        pre, r = f"refiner{lvl}", params[f"refiner{lvl}"]
        _conv(sd, f"{pre}.conv0", r["conv0"])
        _gn(sd, f"{pre}.bn0", r["gn0"])
        for i in range(DILATED_RES_BLOCKS):
            _res(sd, f"{pre}.res{i}", r[f"res{i}"])
        _conv(sd, f"{pre}.conv_final", r["conv_final"])
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C"))
            for k, v in sd.items()}


def init_params_numpy(seed: int = 0, reference: bool = False) -> dict:
    """Seeded fan-in-scale weights in the JAX pytree layout (numpy float32), or with
    ``reference`` the reference's init."""
    rng = np.random.default_rng(seed)
    spread = 0.0 if reference else 0.1

    def normal(shape, std):
        return (std * rng.standard_normal(shape)).astype(np.float32)

    def conv(kshape, cin, cout, bias=True):
        fan_in = int(np.prod(kshape)) * cin
        p = {"w": normal(tuple(kshape) + (cin, cout), 0.01 if reference else fan_in ** -0.5)}
        if bias:
            p["b"] = normal((cout,), spread)
        return p

    def gn(c):
        return {"scale": (1.0 + normal((c,), spread)).astype(np.float32),
                "bias": normal((c,), spread)}

    def res(c, bias=True):
        return {"conv": conv((3, 3), c, c, bias), "gn": gn(c)}

    C = FEATURE_CHANNELS
    fn = {f"conv{i}": conv((5, 5), 3 if i == 0 else C, C, bias=False) for i in range(4)}
    fn.update({f"res{i}": res(C, bias=False) for i in range(6)})
    fn["conv_final"] = conv((3, 3), C, C)

    fr = {"conv0": conv((3, 3), C + 3, 32), "gn0": gn(32), "res0": res(32),
          "conv_final": conv((3, 3), 32, C)}

    vf = {}
    for i in range(4):
        vf[f"conv{i}"] = conv((3, 3, 3), C, C)
        vf[f"gn{i}"] = gn(C)
    vf["conv4"] = conv((3, 3, 3), C, 1)

    params = {"feature_network": fn, "feature_refiner": fr, "volume_filter4": vf}
    for lvl in range(5):
        cg = 3 if lvl == 0 else C + 3
        r = {"conv0": conv((3, 3), cg + 1, 32), "gn0": gn(32),
             "conv_final": conv((3, 3), 32, 1)}
        r.update({f"res{i}": res(32) for i in range(DILATED_RES_BLOCKS)})
        params[f"refiner{lvl}"] = r
    return params


def random_state_dict(seed: int = 0) -> dict:
    """``state_dict_from_jax_params(init_params_numpy(seed))``."""
    return state_dict_from_jax_params(init_params_numpy(seed))


def expected_shapes() -> dict:
    """Every name of the port's state dict (the reference's names) with its shape."""
    return {k: tuple(v.shape) for k, v in random_state_dict().items()}


def check_state_dict(sd: dict, source: str) -> None:
    """Raise a ValueError naming every missing or unexpected name and every wrong shape
    of the state dict ``sd`` read from ``source``."""
    shapes = expected_shapes()
    faults = [f"missing {k}" for k in shapes if k not in sd]
    faults += [f"unexpected {k}" for k in sd if k not in shapes]
    faults += [f"{k}: shape {tuple(v.shape)}, expected {shapes[k]}" for k, v in sd.items()
               if k in shapes and tuple(v.shape) != shapes[k]]
    if faults:
        raise ValueError(f"{source} do not fit the network: {'; '.join(faults)}")

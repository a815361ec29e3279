"""Weights: conversion from the JAX param pytree, seeded initialisers, the training
checkpoints (``native``), the readers of the JAX package's msgpack and the reference's
TorchScript weights, and the serving artifact (``export``)."""

from .convert import init_params_numpy, random_state_dict, state_dict_from_jax_params
from .export import export_inference, load_exported, make_serving_fn, save_exported
from .native import load_any_params
from .torchscript import load_torchscript_weights, state_dict_from_reference

__all__ = ["init_params_numpy", "random_state_dict", "state_dict_from_jax_params",
           "export_inference", "load_exported", "make_serving_fn", "save_exported",
           "load_any_params", "load_torchscript_weights", "state_dict_from_reference"]

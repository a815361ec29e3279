"""Weights: conversion from the JAX param pytree, seeded initialisers, and the
training checkpoints (``native``)."""

from .convert import init_params_numpy, random_state_dict, state_dict_from_jax_params

__all__ = ["init_params_numpy", "random_state_dict", "state_dict_from_jax_params"]

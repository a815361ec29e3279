"""Weight conversion between the JAX param pytree and the port's state dict."""

from .convert import init_params_numpy, random_state_dict, state_dict_from_jax_params

__all__ = ["init_params_numpy", "random_state_dict", "state_dict_from_jax_params"]

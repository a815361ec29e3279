"""Host-side numpy utilities (a copy of the JAX package's jax-free ``depthmap_utils``)."""

"""Host-side utilities: copies of the JAX package's jax-free ``depthmap_utils`` and
``visualization``, and ``timing`` (seeds, CUDA-event timers, profiler traces)."""

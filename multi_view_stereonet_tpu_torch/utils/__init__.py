"""Host-side utilities: copies of the JAX package's jax-free ``depthmap_utils``,
``visualization``, ``pfm_utils`` (PFM files) and ``logger``, and ``timing`` (seeds,
CUDA-event timers, profiler traces)."""

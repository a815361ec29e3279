"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain version.

- ``warp``: bilinear grid sample (``csrc/warp.cu``), for the min-idepth
  warp and the plane sweep.
- ``incremental_chain``: the fused incremental feature chain
  (``csrc/incremental_chain.cu``).
- ``refiner``: the whole idepthmap refiner of a small pyramid level
  (``csrc/idepthmap_refiner.cu``).
- ``gn_apply``: every GroupNorm of the forward, GroupNorm with its
  statistics -> LeakyReLU -> optional residual (``csrc/gn_apply.cu``).

``build`` compiles each kernel with nvcc on first use and routes calls by
tensor device; nothing here is built or imported from triton at import.
"""

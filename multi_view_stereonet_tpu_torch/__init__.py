"""multi_view_stereonet_tpu_torch: the PyTorch / CUDA port of multi_view_stereonet_tpu.

Runs the serving path of the JAX package on an NVIDIA Hopper card
(sm_90a). Same layouts at the public functions (images NHWC, volumes
(B, D, H, W, C), poses and intrinsics (B, 4, 4)), modules named as the
reference network's.

- ``geometry``   closed-form inverses, homographies, idepth sampling
- ``ops``        separable resizes, homography warps; ``ops.cuda`` holds
                 the hand-written kernels (grid sample, incremental chain),
                 each beside its plain PyTorch version
- ``models``     the network as ``nn.Module``s and ``mvsnet_forward``
- ``train``      batch unpacking and params.yaml (training comes later)
- ``eval``       ``serving_forward`` and the single-device ``StreamingRunner``
- ``checkpoint`` JAX pytree -> state dict, and a seeded initialiser
- ``csrc``       CUDA sources, built with nvcc on first use into ``_build/``
- ``data``, ``utils``, ``native``  the host data path (datasets, transforms,
                 batch loader, the g++-built JPEG loader), copied from the JAX
                 package so that the port stands on its own

It imports no JAX and nothing of the JAX package.
"""

__version__ = "0.1.0"
